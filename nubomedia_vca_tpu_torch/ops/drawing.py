"""Overlay rendering — the PyTorch port of ``nubomedia_vca_tpu/ops/drawing.py``:
batched replacements for the reference's in-place OpenCV drawing
(rectangles `BaseFace.cpp:70-82`, circles `kmseyedetect.cpp:1071-1100`,
costume-image alpha blending `kmsfacedetect.cpp:347-502`).

The device functions take fixed-capacity box sets (boxes [B,K,4] + valid
[B,K]) and render with broadcast masks on the frames' device. A slot that
no frame uses is skipped (one host read of ``valid.any(0)`` per call);
that is exact, since such a slot's masks are false everywhere.

Each device function has a `*_np` host twin, copied unchanged from the JAX
package: the serving loop's detect-downscaled mode draws on the retained
full-resolution color frame host-side with them. The rectangle and circle
twins give the device functions' pixels exactly. The blend's twin divides
the alpha by 255 and rounds each product and sum, while the device blend
follows what the JAX package's jitted CPU program computes: a multiply by
float32(1/255) and one fused multiply-add per box. The two can differ by 1
in a uint8 value where the float32 result lies within an ulp of a rounding
boundary (``tests/test_torch_drawing.py`` states the bound).
"""

from __future__ import annotations

import numpy as np
import torch


def _slots(valid: torch.Tensor) -> list[int]:
    """Box slots used by at least one frame."""
    return torch.nonzero(valid.any(0)).flatten().tolist()


def _color(color, C: int, dev: torch.device) -> torch.Tensor:
    return torch.tensor(color[:C], dtype=torch.uint8, device=dev)


def _box_fields(boxes: torch.Tensor, i: int):
    """Slot i's x, y, w, h per frame, shaped [B,1,1] for broadcasting."""
    return [boxes[:, i, k].reshape(-1, 1, 1) for k in range(4)]


def draw_rectangles(img, boxes, valid, color=(0, 255, 0), thickness=2):
    """img [B,H,W] or [B,H,W,C] uint8; boxes [B,K,4] int32; valid [B,K]."""
    gray = img.ndim == 3
    if gray:
        img = img[..., None]
    B, H, W, C = img.shape
    dev = img.device
    ys = torch.arange(H, device=dev).reshape(1, H, 1)
    xs = torch.arange(W, device=dev).reshape(1, 1, W)
    t = thickness
    border = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    for i in _slots(valid):
        x, y, w, h = _box_fields(boxes, i)
        outer = ((xs >= x - t) & (xs <= x + w + t)
                 & (ys >= y - t) & (ys <= y + h + t))
        inner = ((xs >= x + t) & (xs <= x + w - t)
                 & (ys >= y + t) & (ys <= y + h - t))
        border |= outer & ~inner & valid[:, i].reshape(-1, 1, 1)
    # every box paints the same color, so the union equals the JAX
    # package's box-by-box overwrite
    out = torch.where(border[..., None], _color(color, C, dev), img)
    return out[..., 0] if gray else out


def draw_circles(img, boxes, valid, color=(0, 255, 0), thickness=2):
    """Circles inscribed in the boxes (the eye detector draws circles,
    kmseyedetect.cpp:1071-1100)."""
    gray = img.ndim == 3
    if gray:
        img = img[..., None]
    B, H, W, C = img.shape
    dev = img.device
    ys = torch.arange(H, device=dev).reshape(1, H, 1)
    xs = torch.arange(W, device=dev).reshape(1, 1, W)
    ring = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    for i in _slots(valid):
        x, y, w, h = _box_fields(boxes, i)
        cx, cy = x + w // 2, y + h // 2
        r = torch.maximum(w, h) // 2
        d2 = (xs - cx) ** 2 + (ys - cy) ** 2
        ring |= ((d2 <= (r + thickness) ** 2) & (d2 >= (r - thickness) ** 2)
                 & valid[:, i].reshape(-1, 1, 1))
    out = torch.where(ring[..., None], _color(color, C, dev), img)
    return out[..., 0] if gray else out


def blend_overlay_image(img, overlay_rgba, boxes, valid,
                        offset_x_percent=0.0, offset_y_percent=0.0,
                        width_percent=1.0, height_percent=1.0):
    """Alpha-blend a costume image over each detection, scaled and offset
    relative to the box like setOverlayedImage (kmsfacedetect.cpp:427-502).

    img [B,H,W,3] uint8; overlay_rgba [h,w,4] uint8 (alpha 0..255). The
    overlay is resampled per box by nearest lookup into its texture. Per
    box, in float32: alpha = texel_a * float32(1/255) inside the box (0
    outside), acc = fma(acc, 1 - alpha, rgb * alpha); the fused
    multiply-add is computed in float64, where the product is exact, and
    rounded once to float32.
    """
    B, H, W, C = img.shape
    dev = img.device
    oh, ow = overlay_rgba.shape[:2]
    ys = torch.arange(H, device=dev).reshape(1, H, 1)
    xs = torch.arange(W, device=dev).reshape(1, 1, W)
    ov = overlay_rgba.to(dev, torch.float32)
    inv255 = float(np.float32(1.0 / 255.0))
    acc = img.to(torch.float32)
    for i in _slots(valid):
        x, y, w, h = _box_fields(boxes, i)
        dx = x + (offset_x_percent * w).to(torch.int32)
        dy = y + (offset_y_percent * h).to(torch.int32)
        dw = torch.clamp((width_percent * w).to(torch.int32), min=1)
        dh = torch.clamp((height_percent * h).to(torch.int32), min=1)
        inside = (xs >= dx) & (xs < dx + dw) & (ys >= dy) & (ys < dy + dh)
        # texture coordinates (nearest)
        u = torch.clamp(((xs - dx) * ow) // dw, 0, ow - 1)       # [B,1,W]
        v = torch.clamp(((ys - dy) * oh) // dh, 0, oh - 1)       # [B,H,1]
        texel = ov[v, u]                                         # [B,H,W,4]
        alpha = ((texel[..., 3:4] * inv255) * inside[..., None]
                 * valid[:, i].reshape(-1, 1, 1, 1))
        rgb = texel[..., :3]
        acc = (acc.double() * (1 - alpha).double()
               + (rgb * alpha).double()).to(torch.float32)
    return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------- host twins
# numpy implementations for the serving loop's host-side draw
# (detect-downscaled + annotate-full-res), copied unchanged from the JAX
# package. Same box iteration order (later boxes overwrite earlier), same
# masks, same integer arithmetic; the blend's float arithmetic is numpy's.

def draw_rectangles_np(img, boxes, valid, color=(0, 255, 0), thickness=2):
    """Host twin of draw_rectangles: writes only each box's clipped border
    neighborhood. img [B,H,W] or [B,H,W,C] uint8 (copied, not mutated)."""
    gray = img.ndim == 3
    if gray:
        img = img[..., None]
    img = np.array(img, np.uint8, copy=True)
    B, H, W, C = img.shape
    col = np.asarray(color[:C], np.uint8)
    t = thickness
    for b in range(B):
        for i in range(boxes.shape[1]):
            if not valid[b, i]:
                continue
            x, y, w, h = (int(v) for v in boxes[b, i])
            y0, y1 = max(y - t, 0), min(y + h + t + 1, H)
            x0, x1 = max(x - t, 0), min(x + w + t + 1, W)
            if y0 >= y1 or x0 >= x1:
                continue
            ys = np.arange(y0, y1)[:, None]
            xs = np.arange(x0, x1)[None, :]
            inner = ((xs >= x + t) & (xs <= x + w - t)
                     & (ys >= y + t) & (ys <= y + h - t))
            img[b, y0:y1, x0:x1][~inner] = col
    return img[..., 0] if gray else img


def draw_circles_np(img, boxes, valid, color=(0, 255, 0), thickness=2):
    """Host twin of draw_circles (ring inscribed in each box)."""
    gray = img.ndim == 3
    if gray:
        img = img[..., None]
    img = np.array(img, np.uint8, copy=True)
    B, H, W, C = img.shape
    col = np.asarray(color[:C], np.uint8)
    t = thickness
    for b in range(B):
        for i in range(boxes.shape[1]):
            if not valid[b, i]:
                continue
            x, y, w, h = (int(v) for v in boxes[b, i])
            cx, cy = x + w // 2, y + h // 2
            r = max(w, h) // 2
            y0, y1 = max(cy - r - t, 0), min(cy + r + t + 1, H)
            x0, x1 = max(cx - r - t, 0), min(cx + r + t + 1, W)
            if y0 >= y1 or x0 >= x1:
                continue
            ys = np.arange(y0, y1)[:, None]
            xs = np.arange(x0, x1)[None, :]
            d2 = (xs - cx) ** 2 + (ys - cy) ** 2
            ring = (d2 <= (r + t) ** 2) & (d2 >= (r - t) ** 2)
            img[b, y0:y1, x0:x1][ring] = col
    return img[..., 0] if gray else img


def blend_overlay_image_np(img, overlay_rgba, boxes, valid,
                           offset_x_percent=0.0, offset_y_percent=0.0,
                           width_percent=1.0, height_percent=1.0):
    """Host twin of blend_overlay_image: float32 accumulation per frame,
    one round+clip at the end, identical texture-coordinate arithmetic."""
    B, H, W, C = img.shape
    oh, ow = overlay_rgba.shape[:2]
    ov = overlay_rgba.astype(np.float32)
    out = np.empty_like(img)
    for b in range(B):
        acc = img[b].astype(np.float32)
        for i in range(boxes.shape[1]):
            if not valid[b, i]:
                continue
            x, y, w, h = (int(v) for v in boxes[b, i])
            dx = x + int(np.float32(offset_x_percent) * np.float32(w))
            dy = y + int(np.float32(offset_y_percent) * np.float32(h))
            dw = max(int(np.float32(width_percent) * np.float32(w)), 1)
            dh = max(int(np.float32(height_percent) * np.float32(h)), 1)
            y0, y1 = max(dy, 0), min(dy + dh, H)
            x0, x1 = max(dx, 0), min(dx + dw, W)
            if y0 >= y1 or x0 >= x1:
                continue
            ys = np.arange(y0, y1)[:, None]
            xs = np.arange(x0, x1)[None, :]
            u = np.clip(((xs - dx) * ow) // max(dw, 1), 0, ow - 1)
            v = np.clip(((ys - dy) * oh) // max(dh, 1), 0, oh - 1)
            texel = ov[v, u]                              # [y1-y0,x1-x0,4]
            alpha = texel[..., 3:4] / np.float32(255.0)
            rgb = texel[..., :3]
            win = acc[y0:y1, x0:x1]
            acc[y0:y1, x0:x1] = win * (1 - alpha) + rgb * alpha
        out[b] = np.clip(np.round(acc), 0, 255).astype(np.uint8)
    return out
