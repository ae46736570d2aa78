"""Frame batch types — the PyTorch port of
``nubomedia_vca_tpu/core/frames.py``.

The reference receives one BGR/BGRA frame at a time from GStreamer and
mutates it in place (`kmsfacedetect.cpp:282-306` wraps the mapped buffer as
an IplImage). The batched ingest instead gathers frames from many streams
into device tensors: gray (luma) for detection, optional color planes for
overlay rendering. The tensors lie on the device the caller names, the
card unless it asks for another; a CUDA request on a host without CUDA
raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cascade.engine import _resolve_device
from ..ops.color import bgr_to_gray, bgra_to_gray


@dataclasses.dataclass
class FrameBatch:
    """A batch of same-sized frames.

    gray: [B, H, W] uint8 — the detection channel (luma plane for I420/NV12
          ingest, or converted from BGR).
    color: optional [B, H, W, C] uint8 original frames (for overlay output).
    pts: [B] int64 presentation timestamps in nanoseconds (GStreamer pts).
    stream_ids: [B] int32 — which source stream each frame belongs to, when
          batching across streams.
    """

    gray: torch.Tensor
    color: torch.Tensor | None = None
    pts: np.ndarray | None = None
    stream_ids: np.ndarray | None = None

    @property
    def batch(self) -> int:
        return int(self.gray.shape[0])

    @property
    def height(self) -> int:
        return int(self.gray.shape[1])

    @property
    def width(self) -> int:
        return int(self.gray.shape[2])

    @classmethod
    def from_gray(cls, frames, pts=None, device: str | torch.device = "cuda"):
        g = _as_uint8(frames, device)
        if g.ndim == 2:
            g = g[None]
        return cls(gray=g, pts=_default_pts(g.shape[0], pts))

    @classmethod
    def from_bgr(cls, frames, pts=None, device: str | torch.device = "cuda"):
        c = _as_uint8(frames, device)
        if c.ndim == 3:
            c = c[None]
        conv = bgra_to_gray if c.shape[-1] == 4 else bgr_to_gray
        return cls(gray=conv(c), color=c, pts=_default_pts(c.shape[0], pts))

    @classmethod
    def from_i420(cls, y_planes, pts=None,
                  device: str | torch.device = "cuda"):
        """I420/NV12 ingest: the luma plane is used directly (no colorspace
        math on the hot path)."""
        return cls.from_gray(y_planes, pts, device)


def _as_uint8(frames, device) -> torch.Tensor:
    """Host frames (numpy or a tensor) → a uint8 tensor on `device`."""
    dev = _resolve_device(device)
    if isinstance(frames, torch.Tensor):
        return frames.to(dev, torch.uint8)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(frames, np.uint8))).to(dev)


def _default_pts(b: int, pts):
    if pts is None:
        return np.zeros(b, np.int64)
    return np.asarray(pts, np.int64)
