"""Mouth detector — the PyTorch port of ``nubomedia_vca_tpu/models/mouth.py``
(the rebuild of NuboMouthDetector, kmsmouthdetect.cpp).

Per face: the ROI is the lower part of the face — y offset by
half_height = cvRound(height/1.8), same half_height tall
(kmsmouthdetect.cpp:858-865) — searched with the mouth cascade at fixed
factor 1.1, minNeighbors 3, biggest-object semantics
(kmsmouthdetect.cpp:870-873); temporal anti-vibration threshold 4 px
(EUCLIDEAN_DIS, kmsmouthdetect.cpp:25).

The reference's haarcascade_mcs_mouth.xml is used when present in a
cascade search dir; otherwise ``haarcascade_smile.xml``, the OpenCV-shipped
mouth-region cascade, which the port bundles.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..cascade.paths import find_cascade
from .parts import PartDetectorBase, PartDetectorConfig, Roi, cv_round

DEFAULT_MOUTH_CASCADE = ("haarcascade_mcs_mouth.xml",
                         "haarcascade_smile.xml")


@dataclasses.dataclass
class MouthDetectorConfig(PartDetectorConfig):
    euclidean_distance: int = 4
    mouth_cascade_path: str | None = None   # None → find_cascade probe


class MouthDetector(PartDetectorBase):
    FACE_MIN_NEIGHBORS = 2          # kmsmouthdetect.cpp:845-848
    FACE_MIN_SIZE = (3, 3)
    PART_SCALE_FACTOR = 1.1         # MOUTH_SCALE_FACTOR
    PART_MIN_NEIGHBORS = 3
    PART_MIN_SIZE = (1, 1)
    OUTPUT_KEYS = ("mouth",)

    def __init__(self, frame_size, config: MouthDetectorConfig | None = None,
                 device="cuda"):
        config = config or MouthDetectorConfig()
        super().__init__(frame_size, config,
                         {"mouth": config.mouth_cascade_path
                          or find_cascade(*DEFAULT_MOUTH_CASCADE)},
                         device=device)

    def _process_frame(self, faces, part_raw, b):
        cand = self._part_candidates(part_raw, "mouth", b)
        s = self.scale_f2p
        out = []
        for (fx, fy, fw, fh) in np.asarray(faces).reshape(-1, 4):
            half_h = cv_round(fh / 1.8)
            roi = Roi(cv_round(fx * s), cv_round((fy + half_h) * s),
                      cv_round(fw * s), cv_round(half_h * s)).clip(
                self.part_w, self.part_h)
            out.extend(self._roi_detect(cand, roi, biggest=True))
        out = self._merge_consecutive("mouth", out,
                                      self.config.euclidean_distance)
        return {"mouth": self._to_original(out)}
