"""Histogram equalization, bit-exact vs ``cv::equalizeHist``, in PyTorch.

Port of ``nubomedia_vca_tpu/ops/histogram.py``. OpenCV's algorithm: build
a 256-bin histogram, find the first non-empty bin i0,
scale = 255 / (total - hist[i0]), lut[i] = cvRound(cumsum(i0+1..i) * scale)
(round-half-to-even), lut[i0] = 0; a constant image is returned unchanged.
"""

from __future__ import annotations

import torch


def equalize_hist(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] uint8 → uint8, per-image equalization over the last 2 dims."""
    batch_shape = img.shape[:-2]
    H, W = img.shape[-2:]
    flat = img.reshape(-1, H * W).long()
    n = flat.shape[0]
    dev = img.device

    hist = torch.zeros((n, 256), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))

    total = H * W
    bins = torch.arange(256, device=dev)
    # first non-empty bin (a min over indices: no tie-order assumption)
    i0 = torch.where(hist > 0, bins, 256).amin(dim=1)
    h0 = hist.gather(1, i0[:, None])[:, 0]
    scale = 255.0 / torch.clamp(total - h0, min=1).to(torch.float32)
    csum = torch.cumsum(hist, dim=1, dtype=torch.int32)
    sums = csum - csum.gather(1, i0[:, None])
    lut = torch.round(sums.to(torch.float32) * scale[:, None]).clamp_(0, 255)
    lut = lut.to(torch.uint8).masked_fill_(bins[None, :] == i0[:, None], 0)
    out = lut.gather(1, flat)
    out = torch.where((h0 == total)[:, None], flat.to(torch.uint8), out)
    return out.reshape(batch_shape + (H, W))
