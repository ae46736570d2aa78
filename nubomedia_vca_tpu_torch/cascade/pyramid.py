"""Pyramid scale selection — OpenCV detectMultiScale geometry, precomputed.

Reproduces the scale loop of cv::CascadeClassifier::detectMultiScale (the
call the reference makes per frame, ``kmsfacedetect.cpp:809-811``): factors
grow geometrically from 1 by ``scale_factor`` (the reference exposes this as
``multi-scale-factor`` s → 1+s/100, ``kmsfacedetect.cpp:142``); each level
resizes the *original* image by 1/factor and slides the fixed base window.

Everything here is static given (image size, cascade window, knobs) and is
computed on host. A copy of ``nubomedia_vca_tpu/cascade/pyramid.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _cv_round(x: float) -> int:
    return int(np.rint(x))  # round-half-to-even == cvRound


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    factor: float      # pyramid scale factor (window size in original px / base)
    sw: int            # scaled image width  = cvRound(W / factor)
    sh: int            # scaled image height
    ystep: int         # window stride in scaled coords (1 if factor > 2 else 2)
    nx: int            # number of window x-positions (x = ix * ystep)
    ny: int
    out_w: int         # detection width in original coords = cvRound(w0 * factor)
    out_h: int

    @property
    def n_windows(self) -> int:
        return self.nx * self.ny


def compute_levels(
    img_w: int,
    img_h: int,
    win_w: int,
    win_h: int,
    scale_factor: float,
    min_size: tuple[int, int] = (0, 0),
    max_size: tuple[int, int] = (0, 0),
) -> list[LevelSpec]:
    """Enumerate pyramid levels exactly like OpenCV 4.6.

    min_size/max_size are (w, h); (0, 0) means unbounded (max defaults to the
    image size).
    """
    max_w = max_size[0] if max_size[0] > 0 else img_w
    max_h = max_size[1] if max_size[1] > 0 else img_h
    levels = []
    factor = 1.0
    while True:
        ww = _cv_round(win_w * factor)
        wh = _cv_round(win_h * factor)
        if ww > max_w or wh > max_h or ww > img_w or wh > img_h:
            break
        if ww < min_size[0] or wh < min_size[1]:
            factor *= scale_factor
            continue
        sw = _cv_round(img_w / factor)
        sh = _cv_round(img_h / factor)
        ystep = 1 if factor > 2.0 else 2
        gx = sw - win_w + 1
        gy = sh - win_h + 1
        if gx > 0 and gy > 0:
            nx = (gx + ystep - 1) // ystep
            ny = (gy + ystep - 1) // ystep
            levels.append(LevelSpec(factor, sw, sh, ystep, nx, ny, ww, wh))
        factor *= scale_factor
    return levels
