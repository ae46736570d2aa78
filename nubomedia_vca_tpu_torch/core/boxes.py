"""Fixed-capacity box sets — the PyTorch port of
``nubomedia_vca_tpu/core/boxes.py``, the static-shape replacement for the
reference's ``vector<Rect>``.

A box set is a pair (boxes [..., N, 4] int32 x,y,w,h, valid [..., N] bool).
The helpers take torch tensors on any device (and numpy arrays where the
JAX package's did: ``iou`` and ``pad_boxes`` are host helpers).
"""

from __future__ import annotations

import numpy as np
import torch


def centers(boxes: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] → [..., N, 2] (cx, cy) integer centers (x + w/2)."""
    return torch.stack(
        [boxes[..., 0] + boxes[..., 2] // 2, boxes[..., 1] + boxes[..., 3] // 2],
        dim=-1,
    )


def areas(boxes):
    return boxes[..., 2] * boxes[..., 3]


def iou(a, b) -> float:
    """Scalar IoU of two (x, y, w, h) boxes — host-side python floats."""
    ax0, ay0, ax1, ay1 = a[0], a[1], a[0] + a[2], a[1] + a[3]
    bx0, by0, bx1, by1 = b[0], b[1], b[0] + b[2], b[1] + b[3]
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    return inter / max(a[2] * a[3] + b[2] * b[3] - inter, 1e-9)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N,4], b [M,4] → [N,M] IoU (float32)."""
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = torch.clamp(
        torch.minimum(ax2[:, None], bx2[None, :])
        - torch.maximum(ax1[:, None], bx1[None, :]), min=0)
    ih = torch.clamp(
        torch.minimum(ay2[:, None], by2[None, :])
        - torch.maximum(ay1[:, None], by1[None, :]), min=0)
    inter = (iw * ih).to(torch.float32)
    union = (areas(a)[:, None] + areas(b)[None, :]).to(torch.float32) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0), 0.0)


def scale_boxes(boxes: torch.Tensor, scale) -> torch.Tensor:
    """Scale x,y,w,h by a float factor with cvRound (half-even) rounding —
    the reference normalizes detections back to original pixels this way
    (kmsfacedetect.cpp:190,208-211)."""
    return torch.round(boxes.to(torch.float32) * scale).to(torch.int32)


def contains(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """outer [N,4], inner [M,4] → [N,M] bool: inner fully inside outer."""
    ox1, oy1 = outer[:, 0], outer[:, 1]
    ox2, oy2 = outer[:, 0] + outer[:, 2], outer[:, 1] + outer[:, 3]
    ix1, iy1 = inner[:, 0], inner[:, 1]
    ix2, iy2 = inner[:, 0] + inner[:, 2], inner[:, 1] + inner[:, 3]
    return ((ix1[None, :] >= ox1[:, None]) & (iy1[None, :] >= oy1[:, None])
            & (ix2[None, :] <= ox2[:, None]) & (iy2[None, :] <= oy2[:, None]))


def pad_boxes(arr, capacity: int):
    """Host helper: [n,4] → ([capacity,4] int32, [capacity] bool)."""
    arr = np.asarray(arr, np.int32).reshape(-1, 4)
    n = min(len(arr), capacity)
    out = np.zeros((capacity, 4), np.int32)
    val = np.zeros(capacity, bool)
    out[:n] = arr[:n]
    val[:n] = True
    return out, val
