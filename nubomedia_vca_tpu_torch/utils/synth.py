"""Deterministic synthetic gray frames drawn with numpy masks only (no
OpenCV), so a host without cv2 can make frames the port's cascades fire
on: cartoon frontal faces for the real ``haarcascade_frontalface_alt.xml``,
cartoon profile heads for the bundled synthetic profile and ear cascades
(``profile_scene``), moving blobs for the tracker (``blob_clip``), and
motion-history maps that test the labelling of motion components
(``motion_maps``).

The drawing follows the shapes of the JAX package's fixtures
(``tests/fixtures.py``, ``models/synth.draw_profile_face``); pixel edges
differ from cv2's polygon and ellipse fill, which does not matter for what
these frames are for: non-vacuous detection and tracking runs.
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


def _fill_ring(img: np.ndarray, cx: int, cy: int, ax: int, ay: int,
               thickness: int, value: int) -> None:
    """Draw the outline of the axis-aligned ellipse (ax, ay), `thickness`
    px wide and centred on the contour, in place."""
    ax, ay = max(ax, 1), max(ay, 1)
    half = thickness / 2.0
    ox, oy = ax + half, ay + half
    ix, iy = ax - half, ay - half
    h, w = img.shape
    y0, y1 = max(cy - int(oy) - 1, 0), min(cy + int(oy) + 2, h)
    x0, x1 = max(cx - int(ox) - 1, 0), min(cx + int(ox) + 2, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dx, dy = xx - cx, yy - cy
    outer = (dx / ox) ** 2 + (dy / oy) ** 2 <= 1.0
    inner = ((ix > 0) & (iy > 0)
             & ((dx / max(ix, 1e-9)) ** 2 + (dy / max(iy, 1e-9)) ** 2 < 1.0))
    img[y0:y1, x0:x1][outer & ~inner] = value


def _fill_triangle(img: np.ndarray, pts, value: int) -> None:
    """Fill the triangle with integer corners `pts` [(x, y)] * 3 in place
    (edges included)."""
    (xa, ya), (xb, yb), (xc, yc) = pts
    h, w = img.shape
    y0, y1 = max(min(ya, yb, yc), 0), min(max(ya, yb, yc) + 1, h)
    x0, x1 = max(min(xa, xb, xc), 0), min(max(xa, xb, xc) + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]

    def side(px, py, qx, qy):
        return (qx - px) * (yy - py) - (qy - py) * (xx - px)

    s = (side(xa, ya, xb, yb), side(xb, yb, xc, yc), side(xc, yc, xa, ya))
    inside = (((s[0] >= 0) & (s[1] >= 0) & (s[2] >= 0))
              | ((s[0] <= 0) & (s[1] <= 0) & (s[2] <= 0)))
    img[y0:y1, x0:x1][inside] = value


def _fill_line(img: np.ndarray, p, q, thickness: int, value: int) -> None:
    """Draw the segment p-q `thickness` px wide (round ends) in place."""
    (px, py), (qx, qy) = p, q
    r = max(thickness, 1) / 2.0
    h, w = img.shape
    y0 = max(int(min(py, qy) - r) - 1, 0)
    y1 = min(int(max(py, qy) + r) + 2, h)
    x0 = max(int(min(px, qx) - r) - 1, 0)
    x1 = min(int(max(px, qx) + r) + 2, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    vx, vy = qx - px, qy - py
    t = np.clip(((xx - px) * vx + (yy - py) * vy) / max(vx * vx + vy * vy, 1),
                0.0, 1.0)
    d2 = (xx - px - t * vx) ** 2 + (yy - py - t * vy) ** 2
    img[y0:y1, x0:x1][d2 <= r * r] = value


def draw_profile_face(img: np.ndarray, cx: int, cy: int, s: int,
                      skin: int = 205, hair: int = 60) -> None:
    """Draw a left-facing cartoon profile head of "radius" s with a
    pronounced ear, in the shapes of the JAX package's
    ``models/synth.draw_profile_face`` (head, hair cap, nose, eye, brow,
    mouth, a C-shaped ear with an inner shadow)."""
    _fill_ellipse(img, cx, cy, int(0.72 * s), s, skin)
    fx = cx - int(0.72 * s)                                  # facing left
    _fill_ellipse(img, cx + int(0.25 * s), cy - int(0.25 * s),
                  int(0.6 * s), int(0.85 * s), hair)          # hair cap
    _fill_ellipse(img, cx - int(0.05 * s), cy + int(0.1 * s),
                  int(0.6 * s), int(0.78 * s), skin)
    _fill_triangle(img, [(fx + int(0.02 * s), cy - int(0.08 * s)),
                         (fx - int(0.17 * s), cy + int(0.12 * s)),
                         (fx + int(0.02 * s), cy + int(0.2 * s))],
                   skin)                                      # nose
    ex2, ey2 = fx + int(0.28 * s), cy - int(0.24 * s)
    _fill_ellipse(img, ex2, ey2 - int(0.13 * s), int(0.16 * s),
                  int(0.05 * s), 90)                          # brow
    _fill_ellipse(img, ex2, ey2, int(0.1 * s), int(0.07 * s), 35)   # eye
    _fill_line(img, (fx + int(0.02 * s), cy + int(0.42 * s)),
                  (fx + int(0.26 * s), cy + int(0.44 * s)), max(1, s // 14),
                  70)                                         # mouth
    eax, eay = cx + int(0.3 * s), cy + int(0.06 * s)
    ew, eh = int(0.13 * s), int(0.22 * s)
    _fill_ellipse(img, eax, eay, ew, eh, skin)                # ear
    _fill_ring(img, eax, eay, ew, eh, max(2, s // 18), 95)
    _fill_ellipse(img, eax + ew // 3, eay, ew // 2, eh // 2, 130)
    _fill_ellipse(img, eax + ew // 3, eay + eh // 4, max(1, s // 24),
                  max(1, s // 24), 80)


def profile_scene(w: int = 640, h: int = 480,
                  heads=((180, 240, 120, "left"), (460, 240, 120, "right")),
                  noise: int = 6, seed: int = 0, bg: int = 150) -> np.ndarray:
    """Gray uint8 [h, w] frame with cartoon profile heads at
    (cx, cy, s, facing); a right-facing head is the mirror image of a
    left-facing one, which the ear detector finds in its flipped pass."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w), bg, np.uint8)
    if noise:
        img = (img.astype(np.int16)
               + rng.randint(-noise, noise + 1, img.shape)
               ).clip(0, 255).astype(np.uint8)
    for cx, cy, s, facing in heads:
        if facing == "left":
            draw_profile_face(img, int(cx), int(cy), int(s))
        else:
            draw_profile_face(img[:, ::-1], w - 1 - int(cx), int(cy), int(s))
    return img


def blob_clip(n_frames: int = 12, w: int = 320, h: int = 240,
              seed: int = 3) -> np.ndarray:
    """[n_frames, h, w] uint8: a bright disc and a dark box moving over
    static noise, in the layout of the JAX package's tracker fixture scaled
    from 320x240 to w x h; the motion turns back every 24 frames, so that
    any number of frames stays inside the frame."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(60, 80, (h, w)).astype(np.uint8)
    kx, ky = w / 320.0, h / 240.0
    r = int(14 * min(kx, ky))
    frames = []
    for t in range(n_frames):
        p = 24 - abs(t % 48 - 24)
        img = bg.copy()
        _fill_ellipse(img, int((40 + 9 * p) * kx), int((60 + 4 * p) * ky),
                      r, r, 220)
        _fill_box(img, int((250 - 7 * p) * kx), int(160 * ky),
                  int((280 - 7 * p) * kx), int(200 * ky), 25)
        frames.append(img)
    return np.stack(frames)


# float32 seg_thresh of the tracker's default, and the next float above it
_SEG_F32 = np.float32(0.05)
_SEG_ABOVE = np.nextafter(_SEG_F32, np.float32(1.0))


def motion_maps(h: int, w: int, seed: int = 0) -> dict[str, np.ndarray]:
    """[h, w] float32 motion-history maps (timestamps, 0 for no motion)
    for the tracker's seg_thresh of 0.05, by name:

    * ``serpentine``: in the top half a one-pixel snake over every second
      row, joined at alternating ends; in the bottom half one over every
      second column: two long components that cross every tile border;
    * ``speckle``: 35% of the pixels at a tenth of 1..10, the rest 0:
      mostly one-pixel components (equal neighbours link);
    * ``thresh_edge``: bands of 5 rows, each a checkerboard of a small
      base and the base plus float32(0.05) in the left half and plus the
      next float above it in the right half (the base is a multiple of
      2^-28 under 0.0125, so both sums and differences are exact): the
      left half links, the right half does not;
    * ``frame_edges``: runs on all four edges that a wrap-around would
      join (equal values on opposite edges), the four corners and a box
      in the bottom-right corner;
    * ``uniform``: the whole frame at one timestamp (a light switched
      on): one component over every tile;
    * ``zeros``: no motion."""
    rng = np.random.RandomState(seed)
    snake = np.zeros((h, w), np.float32)
    top = h // 2
    for j, y in enumerate(range(0, top, 2)):
        snake[y] = 1.0
        if y + 2 < top:
            snake[y + 1, w - 1 if j % 2 == 0 else 0] = 1.0
    for j, x in enumerate(range(0, w, 2)):
        snake[top + 1:, x] = 2.0
        if x + 2 < w:
            snake[top + 1 if j % 2 == 0 else h - 1, x + 1] = 2.0
    speckle = np.where(rng.rand(h, w) < 0.35,
                       rng.randint(1, 11, (h, w)) / 10.0,
                       0.0).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy // 5) % 12 + 1) * np.float32(2.0 ** -10)
    step = np.where(xx < w // 2, _SEG_F32, _SEG_ABOVE)
    edge = (base + np.where((yy + xx) % 2 == 1, step, 0)).astype(np.float32)
    frame = np.zeros((h, w), np.float32)
    frame[0, 2:max(3, w // 3)] = frame[h - 1, 2:max(3, w // 3)] = 1.0
    frame[2:max(3, h // 3), 0] = frame[2:max(3, h // 3), w - 1] = 2.0
    frame[0, 0] = frame[0, w - 1] = frame[h - 1, 0] = frame[h - 1, w - 1] = 3.0
    frame[h - 1 - h // 4:h - 1, w - 1 - w // 4:] = 4.0
    return {"serpentine": snake, "speckle": speckle, "thresh_edge": edge,
            "frame_edges": frame, "uniform": np.ones((h, w), np.float32),
            "zeros": np.zeros((h, w), np.float32)}
