"""Frame rendering — the PyTorch port of ``nubomedia_vca_tpu/api/render.py``:
the reference's in-place draw path (view-faces rectangles,
BaseFace.cpp:70-82; costume overlay via setOverlayedImage with file/HTTP
URI loaded through libsoup, kmsfacedetect.cpp:347-502).

URIs: plain paths and file:// load via cv2; http(s):// fetches via stdlib
urllib by default (the reference uses libsoup, kmsfacedetect.cpp:375-425) —
a `fetch(url)->bytes` hook can replace it (tests, authenticated CDNs).
Decoding the overlay needs cv2 and stays a host path; the drawing runs on
the frames' device.
"""

from __future__ import annotations

from urllib.parse import urlparse

import numpy as np
import torch

from ..cascade.engine import _resolve_device
from ..core.boxes import pad_boxes
from ..ops.drawing import (blend_overlay_image, blend_overlay_image_np,
                           draw_circles, draw_circles_np, draw_rectangles,
                           draw_rectangles_np)


def _default_fetch(url: str, timeout: float = 10.0) -> bytes:
    """stdlib HTTP fetch (the libsoup-equivalent default,
    kmsfacedetect.cpp:375-425 downloads the costume into a tmpdir)."""
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as r:
        return r.read()


def load_overlay_image(uri: str, fetch=None) -> np.ndarray:
    """uri → RGBA uint8 [h,w,4]. `fetch(url)->bytes` overrides the stdlib
    HTTP loader for http(s) URIs."""
    import cv2
    parsed = urlparse(uri)
    if parsed.scheme in ("", "file"):
        path = parsed.path if parsed.scheme else uri
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(uri)
    elif parsed.scheme in ("http", "https"):
        buf = np.frombuffer((fetch or _default_fetch)(uri), np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"undecodable overlay image from {uri}")
    else:
        raise ValueError(f"unsupported URI scheme {parsed.scheme!r}")
    if img.ndim == 2:                      # gray → BGRA
        img = np.stack([img] * 3 + [np.full_like(img, 255)], axis=-1)
    elif img.shape[2] == 3:                # BGR → BGRA (opaque)
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    # drawing blends RGB; keep BGR order consistent with frames
    return img


def render_detections(frames, rects_per_frame, mode="rect",
                      overlay=None, color=(0, 255, 0), capacity=32,
                      host=False, device: str | torch.device = "cuda"):
    """frames [B,H,W] or [B,H,W,3] uint8 + per-frame rect lists → rendered
    frames. mode: 'rect' | 'circle'; overlay: (rgba image, offsets tuple)
    activates costume blending like setOverlayedImage.

    The result lies on the frames' device: a tensor's own, else `device`
    (the card unless the caller asks for another). host=True draws with
    the numpy twins (ops/drawing.py) and returns numpy — the serving
    loop's detect-downscaled mode, where the full-res annotation canvas
    lives host-side only."""
    if host:
        frames = np.asarray(frames)
    elif isinstance(frames, torch.Tensor):
        dev = frames.device
    else:
        dev = _resolve_device(device)
        frames = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    squeeze = False
    if frames.ndim == 2:
        frames = frames[None]
        squeeze = True
    B = frames.shape[0]
    boxes = np.zeros((B, capacity, 4), np.int32)
    valid = np.zeros((B, capacity), bool)
    for i, rects in enumerate(rects_per_frame[:B]):
        b, v = pad_boxes(np.asarray([r[:4] for r in rects], np.int32)
                         .reshape(-1, 4), capacity)
        boxes[i], valid[i] = b, v
    if not host:
        boxes = torch.from_numpy(boxes).to(dev)
        valid = torch.from_numpy(valid).to(dev)
    if overlay is not None:
        rgba, (ox, oy, wp, hp) = overlay
        if frames.ndim == 3:   # gray frames can't take a color costume
            stack = np.stack if host else torch.stack
            frames = stack([frames] * 3, -1)
        if host:
            out = blend_overlay_image_np(frames, rgba, boxes, valid,
                                         ox, oy, wp, hp)
        else:
            out = blend_overlay_image(frames, torch.as_tensor(rgba).to(dev),
                                      boxes, valid,
                                      ox, oy, wp, hp)
    elif mode == "circle":
        out = (draw_circles_np if host else draw_circles)(
            frames, boxes, valid, color)
    else:
        out = (draw_rectangles_np if host else draw_rectangles)(
            frames, boxes, valid, color)
    return out[0] if squeeze else out
