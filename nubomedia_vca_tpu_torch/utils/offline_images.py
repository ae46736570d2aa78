"""Registry of real photographs discoverable in an offline environment.

The reference framework processes real camera/video frames, but this build
environment has zero egress and ships no media, so real-image evaluation
(tools/real_eval.py) and real-texture hard-negative checks must scavenge
photographs bundled with installed packages. This module centralizes that
discovery so evals and tests agree on the corpus:

  * ``grace_hopper.jpg`` (matplotlib sample data) — a real frontal FACE
    portrait (the classic Grace Hopper test image): the one face-bearing
    real photograph available offline, used to measure real-face recall.
  * ``china.jpg`` / ``flower.jpg`` (scikit-learn sample images) — real
    natural scenes WITHOUT faces: false-positive measurement on real
    high-frequency texture (foliage, roof tiles).

Images the registry returns are BGR uint8 (the production ingest order,
SURVEY.md §2.4.1 — the reference wraps BGR GstBuffers,
kmsfacedetect.cpp:282-306); callers wanting luma should use the same BGR
gray weights as the ingest path. Every entry is EVALUATION-ONLY: training
code must never consume these (tools/real_eval.py's FP numbers would
become circular) — see models/textures.py for the procedural stand-ins
used at training time.

A copy of ``nubomedia_vca_tpu/utils/offline_images.py`` (host-only, like
``models/synth.py``). Where matplotlib, scikit-learn or cv2 is missing,
the photos that need it are left out, so on a host with none of the three
the registry is empty and its callers skip.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class OfflinePhoto:
    name: str           # short identifier (filename)
    bgr: np.ndarray     # [H, W, 3] uint8, BGR channel order
    n_faces: int        # real frontal faces present (0 for scenery)


def _grace_hopper() -> OfflinePhoto | None:
    try:
        import matplotlib
    except ImportError:
        return None
    path = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                        "sample_data", "grace_hopper.jpg")
    if not os.path.exists(path):
        return None
    try:
        import cv2
    except ImportError:
        return None

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        return None
    return OfflinePhoto("grace_hopper.jpg", img, n_faces=1)


def _sklearn_samples() -> list[OfflinePhoto]:
    try:
        from sklearn.datasets import load_sample_images
    except Exception:  # noqa: BLE001 — sklearn may be absent or broken
        return []
    ds = load_sample_images()
    out = []
    for fname, rgb in zip(ds.filenames, ds.images):
        # sklearn decodes to RGB; flip to BGR (production ingest order)
        bgr = np.ascontiguousarray(np.asarray(rgb, np.uint8)[..., ::-1])
        out.append(OfflinePhoto(os.path.basename(str(fname)), bgr,
                                n_faces=0))
    return out


def offline_photos(faces: bool | None = None) -> list[OfflinePhoto]:
    """All offline real photographs; ``faces=True``/``False`` filters to
    face-bearing / face-free subsets. Returns [] where none are bundled
    (callers/tests must skip, not fail)."""
    photos: list[OfflinePhoto] = []
    gh = _grace_hopper()
    if gh is not None:
        photos.append(gh)
    photos.extend(_sklearn_samples())
    if faces is None:
        return photos
    return [p for p in photos if (p.n_faces > 0) == faces]
