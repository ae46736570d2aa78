"""Cascade-file discovery for the PyTorch port.

Probes, in order:

1. the port's own ``assets/haarcascades`` directory, which ships a
   byte-identical copy of OpenCV's ``haarcascade_frontalface_alt.xml``
   (Intel License Agreement header kept), so a host without OpenCV data
   files still has the face cascade;
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
