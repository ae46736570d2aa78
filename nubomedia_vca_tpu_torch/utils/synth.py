"""Deterministic synthetic gray frames with cartoon faces, drawn with numpy
masks only (no OpenCV), so a host without cv2 can make frames that the real
``haarcascade_frontalface_alt.xml`` fires on.

The drawing follows the shapes of the JAX package's test fixture (filled
ellipses for face, brows, eyes and mouth, a bar for the nose); pixel edges
differ from cv2's polygon fill, which does not matter for what these frames
are for: non-vacuous detection and tracking runs.
"""

from __future__ import annotations

import numpy as np


def _fill_ellipse(img: np.ndarray, cx: int, cy: int, ax: int, ay: int,
                  value: int) -> None:
    """Fill the axis-aligned ellipse with semi-axes (ax, ay) in place."""
    ax, ay = max(ax, 1), max(ay, 1)
    h, w = img.shape
    y0, y1 = max(cy - ay, 0), min(cy + ay + 1, h)
    x0, x1 = max(cx - ax, 0), min(cx + ax + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
    img[y0:y1, x0:x1][inside] = value


def _fill_box(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
              value: int) -> None:
    """Fill the inclusive box [x0, x1] x [y0, y1] in place (clipped)."""
    h, w = img.shape
    img[max(y0, 0):min(y1 + 1, h), max(x0, 0):min(x1 + 1, w)] = value


def draw_face(img: np.ndarray, cx: int, cy: int, s: int) -> None:
    """Draw a cartoon face of "radius" s (face ellipse 0.78s x s)."""
    _fill_ellipse(img, cx, cy, int(0.78 * s), s, 205)
    ey = cy - int(0.25 * s)
    ex = int(0.34 * s)
    for sx in (-1, 1):
        _fill_ellipse(img, cx + sx * ex, ey - int(0.18 * s),
                      int(0.22 * s), int(0.06 * s), 95)          # brow
        _fill_ellipse(img, cx + sx * ex, ey,
                      int(0.18 * s), int(0.11 * s), 40)          # eye
    t = max(1, s // 10)
    _fill_box(img, cx - t // 2, cy - int(0.05 * s), cx + (t - 1) // 2,
              cy + int(0.3 * s), 130)                            # nose
    _fill_ellipse(img, cx, cy + int(0.55 * s),
                  int(0.34 * s), int(0.12 * s), 70)              # mouth


def face_scene(w: int = 640, h: int = 480,
               faces=((200, 200, 60), (460, 300, 42)),
               noise: int = 5, seed: int = 0, bg: int = 170) -> np.ndarray:
    """Gray uint8 [h, w] frame with cartoon faces at (cx, cy, s)."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w), bg, np.uint8)
    if noise:
        img = (img.astype(np.int16)
               + rng.randint(-noise, noise + 1, img.shape)
               ).clip(0, 255).astype(np.uint8)
    for cx, cy, s in faces:
        draw_face(img, int(cx), int(cy), int(s))
    return img


def face_clip(n_frames: int = 8, w: int = 640, h: int = 480,
              seed: int = 0) -> np.ndarray:
    """[n_frames, h, w] uint8: one large face drifting a few px per frame,
    sized so it spans about a third of the frame width (the default
    160-px working width then sees it well above the 20x20 window)."""
    k = w / 640.0
    frames = [
        face_scene(w, h,
                   faces=((int((280 + 4 * t) * k), int(h / 2 + 2 * t * k - 10 * k),
                           int(min(150 * k, 0.36 * h))),),
                   noise=5, seed=seed + t)
        for t in range(n_frames)
    ]
    return np.stack(frames)
