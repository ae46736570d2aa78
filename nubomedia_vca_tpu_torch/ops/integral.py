"""Integral images (summed-area tables) in PyTorch.

Port of ``nubomedia_vca_tpu/ops/integral.py``. Tables are [..., H+1, W+1]
int32 with a zero top row and left column, like ``cv::integral``:

* ``integral_image`` — plain sums;
* ``sq_integral_image`` — sums of squares, wrapping around in int32: the
  cascade only takes 4-corner differences over a window, which wraparound
  keeps exact;
* ``tilted_integral_image`` — the 45°-rotated table (RSAT) of tilted Haar
  features (eye and smile cascades).

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


def tilted_integral_image(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] uint8 → [..., H+1, W+1] int32 tilted table, equal to
    ``cv::integral``'s third output (and to the JAX package's
    ``tilted_integral_image``):

        T(y, x) = Σ img[y', x'] over y' < y, |x' - (x-1)| <= y - y' - 1.

    Row y' < y contributes the clipped segment [x-y+y', x+y-y'-2] of
    columns, a difference of its exclusive row prefix sums C (C[y', j] for
    j clamped to [0, W]):

        T(y, x) = Σ_{y'<y} C[y', x+y-1-y'] - Σ_{y'<y} C[y', x-y+y'].

    Each sum runs along a diagonal of C, so skewing C's rows by ±y' turns
    both into plain column prefix sums, read back by gathers. int32
    wraparound addition is associative, so the result is exact whatever
    the order (and equal to the row recurrence of the JAX package's
    ``tilted_integral_image_scan``)."""
    x = img.to(torch.int32)
    return _tilted_from_prefix(
        F.pad(torch.cumsum(x, dim=-1, dtype=torch.int32), (1, 0)))


def tilted_from_integral(ii: torch.Tensor) -> torch.Tensor:
    """[..., H+1, W+1] int32 sum table → the tilted table of the same
    image (``tilted_integral_image``): the exclusive row prefixes C are the
    differences of consecutive table rows."""
    return _tilted_from_prefix(ii[..., 1:, :] - ii[..., :-1, :])


def _tilted_from_prefix(C: torch.Tensor) -> torch.Tensor:
    """Exclusive row prefix sums C [..., H, W+1] int32 → tilted table
    [..., H+1, W+1]."""
    lead, (H, W) = C.shape[:-2], (C.shape[-2], C.shape[-1] - 1)
    C = C.reshape(-1, H, W + 1)
    B, dev = C.shape[0], C.device
    yy = torch.arange(H, device=dev)[:, None]
    k = torch.arange(W + H, device=dev)[None, :]
    # D1[y', k] = C[y', k - y'] and D2[y', m] = C[y', m - H + y'], column
    # indices clamped: below 0 the prefix is 0 (= C[., 0]), above W it is
    # the row total (= C[., W])
    i1 = (k - yy).clamp(0, W)
    i2 = (k - H + yy).clamp(0, W)

    def diag_cumsum(idx):
        d = C.gather(2, idx.expand(B, H, W + H))
        return torch.cumsum(d, dim=1, dtype=torch.int32)   # rows 0..y'

    S1, S2 = diag_cumsum(i1), diag_cumsum(i2)
    # T(y, x) for y >= 1: S1[y-1, x+y-1] - S2[y-1, x-y+H]
    y = torch.arange(1, H + 1, device=dev)[:, None]
    xs = torch.arange(W + 1, device=dev)[None, :]
    a = S1.gather(2, (xs + y - 1).expand(B, H, W + 1))
    b = S2.gather(2, (xs - y + H).expand(B, H, W + 1))
    T = F.pad(a - b, (0, 0, 1, 0))
    return T.reshape(*lead, H + 1, W + 1)
