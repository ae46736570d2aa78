"""Procedural texture backgrounds for CNN training scenes — a copy of
``nubomedia_vca_tpu/models/textures.py`` (numpy and cv2, imported lazily:
on a host without cv2 every generator raises ``ImportError``).

The learned detectors are trained on procedural scenes (models/synth.py)
because the project ships no real media (SURVEY.md §4). Round-2/3
real-image evaluation (tools/real_eval.py --builtin) showed the
flat-noise-background checkpoints are texture-brittle: high-frequency
real-world structure (foliage, roof tiles) draws false positives. These
generators synthesize that structure — multi-octave value noise, gratings,
checkers, edge clutter, gradients — so training scenes carry hard negative
texture WITHOUT training on the evaluation photographs (which would make
the --builtin FP measurement circular).

Used by models/distill.make_scene and models/cnn_parts.scene_with_parts;
NOT by the Haar-cascade trainer scenes (models/synth.py keeps its original
flat-noise recipe so the shipped cascade XMLs stay reproducible).
"""

from __future__ import annotations

import numpy as np


def _value_noise(rng, w, h, cell):
    """Coarse random grid bilinearly upsampled — Perlin-ish value noise."""
    import cv2

    gw, gh = max(2, w // cell), max(2, h // cell)
    grid = rng.randint(0, 256, (gh, gw)).astype(np.uint8)
    return cv2.resize(grid, (w, h), interpolation=cv2.INTER_LINEAR).astype(
        np.float32)


def _multi_octave(rng, w, h):
    """2-3 octaves of value noise: cloudy / foliage-like structure."""
    img = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for cell in rng.permutation([64, 24, 8])[: int(rng.randint(2, 4))]:
        img += amp * _value_noise(rng, w, h, int(cell))
        total += amp
        amp *= 0.55
    return img / total


def _grating(rng, w, h):
    """Sinusoidal grating at random angle/frequency (roof tiles, fences)."""
    theta = rng.uniform(0, np.pi)
    freq = rng.uniform(0.05, 0.6)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = (xx * np.cos(theta) + yy * np.sin(theta)) * freq
    return 127.5 + 127.5 * np.sin(phase + rng.uniform(0, 2 * np.pi))


def _checker(rng, w, h):
    """Checkerboard blocks (windows, brickwork)."""
    cell = int(rng.randint(4, 24))
    yy, xx = np.mgrid[0:h, 0:w]
    a, b = rng.randint(40, 160), rng.randint(120, 230)
    return np.where(((xx // cell) + (yy // cell)) % 2 == 0, a, b).astype(
        np.float32)


def _clutter(rng, w, h):
    """Random lines/ellipses/rectangles over noise — man-made edge soup."""
    import cv2

    img = np.full((h, w), int(rng.randint(60, 200)), np.uint8)
    for _ in range(int(rng.randint(8, 30))):
        g = int(rng.randint(0, 256))
        kind = rng.randint(0, 3)
        x0, y0 = int(rng.randint(0, w)), int(rng.randint(0, h))
        x1, y1 = int(rng.randint(0, w)), int(rng.randint(0, h))
        if kind == 0:
            cv2.line(img, (x0, y0), (x1, y1), g, int(rng.randint(1, 4)))
        elif kind == 1:
            cv2.ellipse(img, (x0, y0),
                        (int(rng.randint(2, w // 4)),
                         int(rng.randint(2, h // 4))),
                        float(rng.uniform(0, 180)), 0, 360, g, -1)
        else:
            cv2.rectangle(img, (min(x0, x1), min(y0, y1)),
                          (max(x0, x1), max(y0, y1)), g,
                          -1 if rng.rand() < 0.5 else int(rng.randint(1, 3)))
    return img.astype(np.float32)


def _gradient(rng, w, h):
    """Smooth linear luminance ramp (sky, walls)."""
    theta = rng.uniform(0, 2 * np.pi)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = xx * np.cos(theta) + yy * np.sin(theta)
    t = (t - t.min()) / max(t.max() - t.min(), 1e-6)
    lo, hi = sorted(rng.randint(0, 256, 2).tolist())
    return lo + t * (hi - lo)


def _bokeh(rng, w, h):
    """Defocused garden/night background: a dark field with soft bright
    blobs (out-of-focus highlights, petals, leaves). Targets the measured
    round-3 real-image failure mode of the face CNN: confident false
    positives on dark smooth defocus regions (flower.jpg scored 0.90 on
    near-black bokeh at the default threshold)."""
    import cv2

    img = np.full((h, w), float(rng.randint(5, 60)), np.float32)
    img += _value_noise(rng, w, h, int(rng.randint(16, 48))) \
        * float(rng.uniform(0.05, 0.3))
    for _ in range(int(rng.randint(4, 14))):
        cx, cy = int(rng.randint(0, w)), int(rng.randint(0, h))
        r = int(rng.randint(4, max(6, min(w, h) // 4)))
        cv2.circle(img, (cx, cy), r, float(rng.randint(110, 255)), -1)
    return cv2.GaussianBlur(img, (0, 0), sigmaX=float(rng.uniform(3, 9)))


def _rosette(rng, w, h):
    """Radial petal clusters on a dark field (flower heads): bright
    near-circular blobs with angular petal modulation and radial ripple —
    the closest texture morphology to a cartoon face outline without any
    facial features, so the detector must key on eyes/mouth structure
    rather than 'bright blob on dark'."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w), float(rng.randint(10, 70)), np.float32)
    for _ in range(int(rng.randint(1, 4))):
        cx, cy = float(rng.randint(0, w)), float(rng.randint(0, h))
        R = float(rng.randint(max(min(w, h) // 6, 4), max(min(w, h) // 2, 8)))
        k = int(rng.randint(6, 18))
        dx, dy = xx - cx, yy - cy
        r = np.sqrt(dx * dx + dy * dy) / R
        th = np.arctan2(dy, dx)
        petal = 0.75 + 0.25 * np.cos(k * th + float(rng.uniform(0, 6.28)))
        ripple = 0.85 + 0.15 * np.cos(r * float(rng.uniform(8, 22)))
        mask = np.clip(1.0 - r / np.maximum(petal, 1e-3), 0, 1)
        img = np.maximum(img, float(rng.randint(130, 240))
                         * (mask ** 0.5) * ripple)
    return img


_DEM_FIELDS: list | None = None


def _dem_fields() -> list:
    """Real-terrain height fields bundled with matplotlib (sample_data
    jacksboro_fault_dem / topobathy): true natural-world 1/f statistics
    (ridges, valleys, drainage) that are neither photographs nor
    procedural — and NOT the real-image evaluation photos, so training on
    them keeps tools/real_eval.py --builtin non-circular."""
    global _DEM_FIELDS
    if _DEM_FIELDS is not None:
        return _DEM_FIELDS
    fields = []
    try:
        import os

        import matplotlib

        base = os.path.join(os.path.dirname(matplotlib.__file__),
                            "mpl-data", "sample_data")
        for fname, key in (("jacksboro_fault_dem.npz", "elevation"),
                           ("topobathy.npz", "topo")):
            path = os.path.join(base, fname)
            if os.path.exists(path):
                with np.load(path) as d:
                    fields.append(np.asarray(d[key], np.float32))
    except Exception:
        pass
    _DEM_FIELDS = fields
    return fields


def _terrain(rng, w, h):
    """Hillshaded random crop of a real DEM (see _dem_fields): directional
    lighting over natural relief produces photo-like shading with smooth
    dark slopes and bright ridgelines."""
    import cv2

    fields = _dem_fields()
    if not fields:
        return _multi_octave(rng, w, h)
    z = fields[int(rng.randint(len(fields)))]
    fh, fw = z.shape
    cw = int(rng.randint(24, fw + 1))
    ch = int(rng.randint(24, fh + 1))
    x0 = int(rng.randint(0, fw - cw + 1))
    y0 = int(rng.randint(0, fh - ch + 1))
    crop = z[y0:y0 + ch, x0:x0 + cw]
    k = int(rng.randint(0, 4))
    if k:
        crop = np.rot90(crop, k)
    if rng.rand() < 0.5:
        crop = crop[:, ::-1]
    crop = cv2.resize(np.ascontiguousarray(crop), (w, h),
                      interpolation=cv2.INTER_LINEAR)
    gy, gx = np.gradient(crop * float(rng.uniform(0.02, 0.15)))
    az = float(rng.uniform(0, 2 * np.pi))
    alt = float(rng.uniform(0.4, 1.2))
    nz = 1.0 / np.sqrt(gx * gx + gy * gy + 1.0)
    shade = nz * (np.sin(alt)
                  - gx * np.cos(alt) * np.cos(az)
                  - gy * np.cos(alt) * np.sin(az))
    return np.clip(shade, 0, 1) * 255.0


_KINDS = (_multi_octave, _grating, _checker, _clutter, _gradient)

# Round-3b additions targeting the face CNN's measured real-image FP
# morphology (see each family's docstring). Kept OUT of _KINDS because
# cnn_parts' shipped checkpoint + per-class operating points were
# measured against the any_bg distribution; face training opts in via
# face_bg below.
_FACE_EXTRA_KINDS = (_bokeh, _rosette, _terrain)


def _patchwork(rng, w, h, kinds):
    """Voronoi composite of texture families — a real scene's coarse
    segmentation (sky/roof/foliage regions, each with its own texture and
    exposure). Region boundaries are additional hard edge structure."""
    n = int(rng.randint(2, 5))
    sx = rng.randint(0, w, n).astype(np.float32)
    sy = rng.randint(0, h, n).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = (xx[None] - sx[:, None, None]) ** 2 \
        + (yy[None] - sy[:, None, None]) ** 2
    lab = d.argmin(axis=0)
    img = np.zeros((h, w), np.float32)
    for i in range(n):
        tex = kinds[int(rng.randint(len(kinds)))](rng, w, h)
        tex = (tex - tex.min()) / max(tex.max() - tex.min(), 1e-6)
        span = float(rng.uniform(30, 160))
        lo = float(rng.uniform(0, 255 - span))
        img = np.where(lab == i, lo + tex * span, img)
    return img


def textured_bg(rng, w: int, h: int, kinds=_KINDS,
                patchwork: bool = False) -> np.ndarray:
    """uint8 [h, w] background: one random texture family, contrast-
    compressed to a random sub-range plus pixel noise (real sensor grain),
    so drawn faces (opaque, mid-to-high luminance) stay visible while the
    background carries hard high-frequency negatives."""
    if patchwork and rng.rand() < 0.25:
        tex = _patchwork(rng, w, h, kinds)
    else:
        tex = kinds[int(rng.randint(len(kinds)))](rng, w, h)
    tex = (tex - tex.min()) / max(tex.max() - tex.min(), 1e-6)
    span = rng.uniform(40, 170)
    lo = rng.uniform(0, 255 - span)
    if patchwork and rng.rand() < 0.2:
        # low-key exposure: real night/defocus scenes sit near black, a
        # region the base recipe almost never reaches (round-3 measured
        # scene minimum was 38/255) — and where flower.jpg's FPs lived
        lo = rng.uniform(0, 18)
    out = lo + tex * span + rng.randint(-6, 7, (h, w))
    return np.clip(out, 0, 255).astype(np.uint8)


def any_bg(rng, w: int, h: int, p_textured: float = 0.6) -> np.ndarray:
    """Mix of textured and classic flat-noise backgrounds."""
    if rng.rand() < p_textured:
        return textured_bg(rng, w, h)
    from .synth import _noise_bg

    return _noise_bg(rng, w, h)


def face_bg(rng, w: int, h: int, p_textured: float = 0.7) -> np.ndarray:
    """Background distribution for the FACE distillation scenes: the base
    families plus _FACE_EXTRA_KINDS and Voronoi patchwork composites.
    Separate from any_bg so the multi-part model's shipped checkpoint and
    measured operating points (cnn_parts.DEFAULT_THRESHOLDS) stay valid."""
    if rng.rand() < p_textured:
        return textured_bg(rng, w, h, kinds=_KINDS + _FACE_EXTRA_KINDS,
                           patchwork=True)
    from .synth import _noise_bg

    return _noise_bg(rng, w, h)
