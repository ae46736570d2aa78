"""Canonical synthetic scenes for training and fixtures — a copy of
``nubomedia_vca_tpu/models/synth.py`` (numpy and cv2, imported lazily: on
a host without cv2 every drawing function raises ``ImportError``; the
port's cv2-free frames are ``utils/synth.py``).

The reference ships no media and its mcs nose/ear cascade models are not
redistributable (SURVEY.md §4; kmsnosedetect.cpp:32, kmseardetect.cpp:30-31).
The framework therefore trains its own substitute part cascades
(cascade/train.py + tools/train_part_cascades.py) on procedural scenes, and
those scenes live here: a frontal cartoon face tuned to fire
haarcascade_frontalface_alt (the same recipe as tests/fixtures.draw_face),
plus a left-facing profile cartoon with a pronounced ear used to train the
synthetic profile/ear cascades (the real haarcascade_profileface, trained on
photographs, does not fire on cartoons — measured 0/160 parameter trials —
so the profile fixture pipeline ships its own cascade).

Every sampler returns uint8 gray images; crops are resized to the training
window with cv2 INTER_LINEAR_EXACT (bit-exact with ops/resize.py per the
parity suite), so training sees exactly the pixels the engine's pyramid
produces at detection time.
"""

from __future__ import annotations

import numpy as np

from ..core.boxes import iou as _iou


# ------------------------------------------------------------ frontal face
def draw_face(img: np.ndarray, cx: int, cy: int, s: int,
              skin: int = 205) -> dict:
    """Cartoon frontal face ("radius" s) tuned to fire
    haarcascade_frontalface_alt; returns part geometry in pixels
    (nose box, eye boxes, mouth box) for crop sampling."""
    import cv2

    cv2.ellipse(img, (cx, cy), (int(0.78 * s), s), 0, 0, 360, skin, -1)
    ey = cy - int(0.25 * s)
    ex = int(0.34 * s)
    eyes = []
    for sx in (-1, 1):
        cv2.ellipse(img, (cx + sx * ex, ey - int(0.18 * s)),
                    (int(0.22 * s), int(0.06 * s)), 0, 0, 360, 95, -1)
        cv2.ellipse(img, (cx + sx * ex, ey), (int(0.18 * s), int(0.11 * s)),
                    0, 0, 360, 40, -1)
        eyes.append((cx + sx * ex - int(0.22 * s), ey - int(0.26 * s),
                     int(0.44 * s), int(0.4 * s)))
    # nose: vertical ridge with a base shadow and nostrils — enough
    # structure for a 20x20 Haar window (the bare line of the original
    # fixture recipe is kept for silhouette compatibility)
    cv2.line(img, (cx, cy - int(0.05 * s)), (cx, cy + int(0.3 * s)),
             130, max(1, s // 10))
    cv2.ellipse(img, (cx, cy + int(0.3 * s)),
                (int(0.13 * s), int(0.06 * s)), 0, 0, 180, 110, -1)
    for sx in (-1, 1):
        cv2.circle(img, (cx + sx * int(0.08 * s), cy + int(0.3 * s)),
                   max(1, s // 20), 90, -1)
    cv2.ellipse(img, (cx, cy + int(0.55 * s)), (int(0.34 * s), int(0.12 * s)),
                0, 0, 360, 70, -1)
    half = int(0.26 * s)
    return {
        "face": (cx - int(0.78 * s), cy - s, int(1.56 * s), 2 * s),
        "nose": (cx - half, cy + int(0.12 * s) - half, 2 * half, 2 * half),
        "eyes": eyes,
        "mouth": (cx - int(0.34 * s), cy + int(0.43 * s),
                  int(0.68 * s), int(0.24 * s)),
    }


# ------------------------------------------------------------ profile face
def draw_profile_face(img: np.ndarray, cx: int, cy: int, s: int,
                      skin: int = 205, hair: int = 60) -> dict:
    """Left-facing cartoon profile head with a pronounced ear; returns the
    head box and ear box. Trains the synthetic profile + ear cascades; the
    right side is covered by the ear detector's flip pass
    (kmseardetect.cpp:796-803)."""
    import cv2

    cv2.ellipse(img, (cx, cy), (int(0.72 * s), s), 0, 0, 360, skin, -1)
    fx = cx - int(0.72 * s)                      # face edge (facing left)
    # hair cap over the top/back
    cv2.ellipse(img, (cx + int(0.25 * s), cy - int(0.25 * s)),
                (int(0.6 * s), int(0.85 * s)), 0, 0, 360, hair, -1)
    cv2.ellipse(img, (cx - int(0.05 * s), cy + int(0.1 * s)),
                (int(0.6 * s), int(0.78 * s)), 0, 0, 360, skin, -1)
    # nose silhouette
    pts = np.array([[fx + int(0.02 * s), cy - int(0.08 * s)],
                    [fx - int(0.17 * s), cy + int(0.12 * s)],
                    [fx + int(0.02 * s), cy + int(0.2 * s)]], np.int32)
    cv2.fillPoly(img, [pts], skin)
    # eye + brow near the face edge
    ex2, ey2 = fx + int(0.28 * s), cy - int(0.24 * s)
    cv2.ellipse(img, (ex2, ey2 - int(0.13 * s)),
                (int(0.16 * s), int(0.05 * s)), 0, 0, 360, 90, -1)
    cv2.ellipse(img, (ex2, ey2), (int(0.1 * s), int(0.07 * s)),
                0, 0, 360, 35, -1)
    # mouth
    cv2.line(img, (fx + int(0.02 * s), cy + int(0.42 * s)),
             (fx + int(0.26 * s), cy + int(0.44 * s)), 70, max(1, s // 14))
    # ear: C-shaped ridge with inner shadow at the back half
    eax, eay = cx + int(0.3 * s), cy + int(0.06 * s)
    ew, eh = int(0.13 * s), int(0.22 * s)
    cv2.ellipse(img, (eax, eay), (ew, eh), 0, 0, 360, skin, -1)
    cv2.ellipse(img, (eax, eay), (ew, eh), 0, 0, 360, 95,
                max(2, s // 18))
    cv2.ellipse(img, (eax + ew // 3, eay), (ew // 2, eh // 2),
                0, 0, 360, 130, -1)
    cv2.circle(img, (eax + ew // 3, eay + eh // 4), max(1, s // 24), 80, -1)
    return {
        "head": (cx - int(0.9 * s), cy - s, int(1.62 * s), 2 * s),
        "ear": (eax - int(1.6 * ew), eay - int(1.3 * eh),
                int(3.2 * ew), int(2.6 * eh)),
    }


# ---------------------------------------------------------------- samplers
def _jitter_crop(img, box, rng, window, pos_jitter=0.08, scale_jitter=0.12):
    """Randomly jittered crop of `box` resized to the training window —
    teaches tolerance to the detection pyramid's scale/offset quantization
    (factor-1.1 levels + ystep grid)."""
    import cv2

    x, y, w, h = box
    js = 1.0 + rng.uniform(-scale_jitter, scale_jitter)
    jw, jh = int(round(w * js)), int(round(h * js))
    jx = x + int(round(rng.uniform(-pos_jitter, pos_jitter) * w))
    jy = y + int(round(rng.uniform(-pos_jitter, pos_jitter) * h))
    H, W = img.shape
    if jw < 4 or jh < 4 or jw > W or jh > H:
        # reject (don't clamp-and-truncate): a silently truncated crop
        # would be resized as if it were jw x jh, distorting the sample
        return None
    jx = max(0, min(W - jw, jx))
    jy = max(0, min(H - jh, jy))
    crop = img[jy:jy + jh, jx:jx + jw]
    return cv2.resize(crop, window, interpolation=cv2.INTER_LINEAR_EXACT)


def _noise_bg(rng, w=640, h=480):
    img = np.full((h, w), int(rng.randint(70, 200)), np.uint8)
    return np.clip(img.astype(np.int16)
                   + rng.randint(-6, 7, img.shape), 0, 255).astype(np.uint8)


def _frontal_scene(rng):
    img = _noise_bg(rng)
    s = int(rng.randint(60, 170))
    skin = int(rng.randint(185, 225))
    cx = int(rng.randint(int(0.9 * s), 640 - int(0.9 * s)))
    cy = int(rng.randint(s, 480 - s))
    geo = draw_face(img, cx, cy, s, skin)
    return img, geo


def _profile_scene(rng):
    img = _noise_bg(rng)
    s = int(rng.randint(60, 170))
    skin = int(rng.randint(185, 225))
    hair = int(rng.randint(35, 95))
    cx = int(rng.randint(s, 640 - s))
    cy = int(rng.randint(s, 480 - s))
    geo = draw_profile_face(img, cx, cy, s, skin, hair)
    return img, geo


def _rects_overlap(a, b):
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    return not (ax + aw <= bx or bx + bw <= ax
                or ay + ah <= by or by + bh <= ay)


def make_texture_sampler(window=(20, 20)):
    """negative_sampler(n, rng) drawing crops from the round-3 texture
    families (models/textures.py — bokeh/rosette/terrain/patchwork and the
    base kinds): the hard-negative distribution that exposed the CNN's
    texture brittleness on real photos (BASELINE.md round 3). Used both to
    texture-harden the trained part cascades (mixed into make_samplers'
    negatives) and as the textured holdout the trainer reports FP on."""
    from .textures import _KINDS, _FACE_EXTRA_KINDS, textured_bg

    kinds = _KINDS + _FACE_EXTRA_KINDS

    def texture_negatives(n, rng):
        out = []
        while len(out) < n:
            img = textured_bg(rng, 320, 240, kinds=kinds, patchwork=True)
            for _ in range(30):
                if len(out) >= n:
                    break
                sz = int(rng.randint(12, 200))
                box = (int(rng.randint(0, max(1, 320 - sz))),
                       int(rng.randint(0, max(1, 240 - sz))), sz, sz)
                crop = _jitter_crop(img, box, rng, window, 0.0, 0.0)
                if crop is not None and crop.std() > 11:
                    out.append(crop)
        return np.stack(out)

    return texture_negatives


def make_samplers(part: str, window=(20, 20),
                  texture_neg_frac: float = 0.3):
    """(positive_sampler(n, rng), negative_sampler(n, rng)) for
    part ∈ {'nose', 'ear', 'profile'}. Negatives are crops of everything
    that is NOT the part — other face parts, face edges, background — the
    discrimination the detection pipeline actually needs; a
    texture_neg_frac share comes from the round-3 texture families
    (make_texture_sampler) so the trained cascades stay quiet on real
    high-frequency texture, the same lesson the CNN's texture-robustness
    retrain applied (VERDICT r3 item 5)."""

    scene_fn = _frontal_scene if part == "nose" else _profile_scene
    pos_key = {"nose": "nose", "ear": "ear", "profile": "head"}[part]
    texture_negatives = make_texture_sampler(window)

    def positives(n, rng):
        out = []
        while len(out) < n:
            img, geo = scene_fn(rng)
            crop = _jitter_crop(img, geo[pos_key], rng, window)
            if crop is not None and crop.std() > 12:
                out.append(crop)
        return np.stack(out)

    def negatives(n, rng):
        n_tex = int(round(n * texture_neg_frac))
        out = list(texture_negatives(n_tex, rng)) if n_tex else []
        while len(out) < n:
            img, geo = scene_fn(rng)
            avoid = geo[pos_key]
            # crops of other structures + random crops avoiding the part
            cands = []
            if part == "nose":
                cands += list(geo["eyes"]) + [geo["mouth"]]
            if part != "profile":
                # LOCALIZATION negatives: off-center / wrong-scale crops
                # of the part itself (IoU-filtered below) teach the
                # cascade to fire only when centered, tightening the
                # grouped-box localization the ROI pipeline reports
                x, y, w2, h2 = avoid
                for _ in range(8):
                    dx = int(rng.choice([-1, 1])
                             * rng.uniform(0.45, 1.0) * w2)
                    dy = int(rng.choice([-1, 1])
                             * rng.uniform(0.45, 1.0) * h2)
                    cands.append((x + dx, y + dy, w2, h2))
                cands.append((x - w2 // 2, y - h2 // 2, 2 * w2, 2 * h2))
                cands.append((x - w2, y - h2, 3 * w2, 3 * h2))
            H, W = img.shape
            for _ in range(40):   # many crops per scene: scene synthesis
                sz = int(rng.randint(12, 160))   # dominates sampling cost
                cands.append((int(rng.randint(0, max(1, W - sz))),
                              int(rng.randint(0, max(1, H - sz))), sz, sz))
            for box in cands:
                if len(out) >= n:
                    break
                if part != "profile" and _iou(box, avoid) > 0.25:
                    continue   # too part-like to be a negative
                if part == "profile" and _rects_overlap(box, avoid):
                    # head sub-crops smaller than half the head are fine
                    # negatives; near-full-head crops are not
                    if box[2] > avoid[2] // 2:
                        continue
                crop = _jitter_crop(img, box, rng, window, 0.0, 0.0)
                if crop is not None and crop.std() > 11:
                    out.append(crop)
        out = np.stack(out[:n])
        rng.shuffle(out)   # mix texture and scene negatives across batches
        return out

    return positives, negatives
