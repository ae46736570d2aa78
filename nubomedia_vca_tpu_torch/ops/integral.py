"""Integral images (summed-area tables) in PyTorch.

Port of ``nubomedia_vca_tpu/ops/integral.py`` (the plain and squared
tables; the tilted table waits for the part-chain slice). Tables are
[..., H+1, W+1] int32 with a zero top row and left column, like
``cv::integral``. The squared table wraps around in int32: the cascade only
takes 4-corner differences over a window, which wraparound keeps exact.

``torch.cumsum`` on int32 returns int64 unless ``dtype`` says otherwise, so
every cumsum here names ``torch.int32``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sat(x: torch.Tensor) -> torch.Tensor:
    s = torch.cumsum(torch.cumsum(x, dim=-1, dtype=torch.int32),
                     dim=-2, dtype=torch.int32)
    return F.pad(s, (1, 0, 1, 0))


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] uint8/int32 → [..., H+1, W+1] int32 summed-area table."""
    return _sat(img.to(torch.int32))


def sq_integral_image(img: torch.Tensor) -> torch.Tensor:
    """Integral of squared pixels, int32 with wraparound."""
    x = img.to(torch.int32)
    return _sat(x * x)
