"""Exact INTER_LINEAR_EXACT resize in PyTorch.

Port of ``nubomedia_vca_tpu/ops/resize.py``: bit-exact vs
``cv::resize(..., INTER_LINEAR_EXACT)``, the interpolation OpenCV's cascade
pyramid uses.

Scheme (verified bit-exact against OpenCV 4.6 by the JAX package):
  source position for output x:  fx = ((2x+1)*src - dst) / (2*dst)
  sx = floor(fx); frac = fx - sx (clamped to 0 when sx < 0)
  Q8 coefficients: c1 = round_half_even(frac * 256), c0 = 256 - c1
  horizontal pass in Q8 int, vertical pass in Q16 int,
  final: (v + 2^15) >> 16  (round half up), clipped to [0, 255]
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=512)
def _linear_exact_tables(src: int, dst: int):
    x = np.arange(dst)
    fx = ((2 * x + 1) * src - dst) / (2 * dst)
    sx = np.floor(fx).astype(np.int64)
    frac = np.where(sx < 0, 0.0, fx - sx)
    s0 = np.clip(sx, 0, src - 1)
    s1 = np.clip(s0 + 1, 0, src - 1)
    c1 = np.round(frac * 256).astype(np.int32)
    c0 = 256 - c1
    return (s0.astype(np.int32), s1.astype(np.int32), c0, c1)


@functools.lru_cache(maxsize=512)
def _tables_on(src: int, dst: int, device: torch.device):
    """The tables as tensors on `device`: int64 indices, int32 Q8 weights."""
    s0, s1, c0, c1 = _linear_exact_tables(src, dst)
    return (torch.from_numpy(s0).long().to(device),
            torch.from_numpy(s1).long().to(device),
            torch.from_numpy(c0).to(device),
            torch.from_numpy(c1).to(device))


def resize_linear_exact(img: torch.Tensor,
                        dsize: tuple[int, int]) -> torch.Tensor:
    """[..., H, W] uint8 → [..., dh, dw] uint8, bit-exact INTER_LINEAR_EXACT.

    dsize is (width, height), matching cv::resize argument order. All
    arithmetic is int32 on the input's device.
    """
    dw, dh = dsize
    sh, sw = img.shape[-2], img.shape[-1]
    if (sw, sh) == (dw, dh):
        return img
    sx0, sx1, cx0, cx1 = _tables_on(sw, dw, img.device)
    sy0, sy1, cy0, cy1 = _tables_on(sh, dh, img.device)
    im = img.to(torch.int32)
    # horizontal: [..., H, dw] in Q8
    h = im[..., sx0] * cx0 + im[..., sx1] * cx1
    # vertical: [..., dh, dw] in Q16
    v = h[..., sy0, :] * cy0[:, None] + h[..., sy1, :] * cy1[:, None]
    out = (v + (1 << 15)) >> 16
    return out.clamp_(0, 255).to(torch.uint8)
