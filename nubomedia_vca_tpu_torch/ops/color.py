"""Colorspace conversions — the PyTorch port of
``nubomedia_vca_tpu/ops/color.py`` (exact OpenCV uint8 semantics where it
matters).

The reference elements receive BGR/BGRA frames from GStreamer and call
``cvtColor(..., CV_BGR2GRAY)`` per frame (``kmsfacedetect.cpp:806``,
``gstnubotracker.cpp:356``). Here conversion is a batched op on the frames'
device; for planar YUV ingest (I420/NV12) the luma plane is used directly.
"""

from __future__ import annotations

import torch

# OpenCV bit-exact BGR→gray coefficients (Q15: 9798R + 19235G + 3735B).
_R, _G, _B, _SHIFT = 9798, 19235, 3735, 15


def _q15_gray(r, g, b) -> torch.Tensor:
    y = (r * _R + g * _G + b * _B + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.to(torch.uint8)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 BGR → [..., H, W] uint8 gray, bit-exact vs OpenCV.

    y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15   (bit-exact COLOR_BGR2GRAY)
    """
    x = img.to(torch.int32)
    return _q15_gray(x[..., 2], x[..., 1], x[..., 0])


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    x = img.to(torch.int32)
    return _q15_gray(x[..., 0], x[..., 1], x[..., 2])


def bgra_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 4] BGRA → gray (alpha ignored; matches CV_BGRA2GRAY)."""
    return bgr_to_gray(img[..., :3])


def i420_luma(y_plane: torch.Tensor) -> torch.Tensor:
    """I420/NV12 luma plane is already the gray channel — identity view."""
    return y_plane


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """BT.601 full-range YUV420 planes → uint8 BGR (for overlay/export paths).

    y: [..., H, W]; u, v: [..., H/2, W/2]. Chroma is nearest-upsampled.
    float32 throughout, each product and sum rounded on its own, as the
    JAX package's jitted CPU program computes it (XLA:CPU fuses no FMA
    here; ``tests/test_torch_drawing.py`` holds it).
    """
    def up(c):
        c = c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        return c.to(torch.float32) - 128.0

    u2, v2 = up(u), up(v)
    yf = y.to(torch.float32)
    r = yf + 1.402 * v2
    g = yf - 0.344136 * u2 - 0.714136 * v2
    b = yf + 1.772 * u2
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.round(bgr), 0, 255).to(torch.uint8)
