"""Cascade-file discovery for the PyTorch port.

Probes, in order:

1. the port's own ``assets/haarcascades`` directory, which ships
   byte-identical copies of OpenCV's ``haarcascade_frontalface_alt.xml``,
   ``haarcascade_{right,left}eye_2splits.xml``, ``haarcascade_smile.xml``
   and ``haarcascade_profileface.xml`` (license headers kept) and of the
   JAX package's trained ``vca_nose_synthetic.xml``,
   ``vca_profileface_synthetic.xml`` and ``vca_ear_synthetic.xml``, so a
   host without OpenCV data files still has the face and part cascades;
2. ``$VCA_CASCADE_PATH`` (colon-separated directories);
3. the reference's OpenCV 2.x system dir;
4. the modern OpenCV 4 system dir.
"""

from __future__ import annotations

import os

REFERENCE_DIR = "/usr/share/opencv/haarcascades"   # reference's hard-coded dir
SYSTEM_DIR = "/usr/share/opencv4/haarcascades"
PKG_ASSETS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "assets", "haarcascades"))


def search_dirs() -> list[str]:
    dirs = [PKG_ASSETS_DIR]
    env = os.environ.get("VCA_CASCADE_PATH")
    if env:
        dirs.extend(p for p in env.split(":") if p)
    return dirs + [REFERENCE_DIR, SYSTEM_DIR]


def find_cascade(*names: str) -> str | None:
    """First existing file among ``names`` probed across ``search_dirs()``
    (all dirs tried for the first name before moving to the next name, so
    name order expresses model preference)."""
    for name in names:
        if os.path.isabs(name) and os.path.exists(name):
            return name
        for d in search_dirs():
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
    return None
