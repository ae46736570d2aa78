"""Category logging — GStreamer debug-category analog (SURVEY.md §5).

The reference registers one GST_DEBUG_CATEGORY per element
(kmsfacedetect.cpp:51-52); here each filter/module gets a namespaced stdlib
logger with one env knob: VCA_DEBUG="face:DEBUG,engine:INFO" (mirrors the
GST_DEBUG syntax).

A copy of ``nubomedia_vca_tpu/utils/logging.py``.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "nubovca"
_configured = False


def _configure():
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    root.addHandler(handler)
    root.setLevel(logging.WARNING)
    spec = os.environ.get("VCA_DEBUG", "")
    for item in spec.split(","):
        if not item.strip():
            continue
        cat, _, level = item.partition(":")
        logging.getLogger(f"{_ROOT}.{cat.strip()}".rstrip(".")).setLevel(
            getattr(logging, (level or "DEBUG").strip().upper(),
                    logging.DEBUG))
    _configured = True


def get_logger(category: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"{_ROOT}.{category}")
