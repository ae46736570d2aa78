"""Nose detector — the PyTorch port of ``nubomedia_vca_tpu/models/nose.py``
(the rebuild of NuboNoseDetector, kmsnosedetect.cpp).

Per face: center ROI with TOP 25% / DOWN 10% cropped and SIDE 25% trimmed
from the left (kmsnosedetect.cpp:34-36,855-865); nose cascade at fixed
factor 1.1, minNeighbors 3, biggest-object semantics
(kmsnosedetect.cpp:870-873); temporal anti-vibration 6 px (EUCLIDEAN_DIS,
kmsnosedetect.cpp:43).

The reference's haarcascade_mcs_nose.xml is used when present in a cascade
search dir (cascade/paths.py); otherwise the port's bundled copy of the
JAX package's trained ``vca_nose_synthetic.xml``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..cascade.paths import find_cascade
from .parts import PartDetectorBase, PartDetectorConfig, Roi, cv_round

TOP_PERCENTAGE = 25    # kmsnosedetect.cpp:34
DOWN_PERCENTAGE = 10   # kmsnosedetect.cpp:35
SIDE_PERCENTAGE = 25   # kmsnosedetect.cpp:36


@dataclasses.dataclass
class NoseDetectorConfig(PartDetectorConfig):
    euclidean_distance: int = 6
    nose_cascade_path: str | None = None


class NoseDetector(PartDetectorBase):
    FACE_MIN_NEIGHBORS = 2          # kmsnosedetect.cpp:843-846
    FACE_MIN_SIZE = (3, 3)
    PART_SCALE_FACTOR = 1.1         # NOSE_SCALE_FACTOR
    PART_MIN_NEIGHBORS = 3
    PART_MIN_SIZE = (1, 1)
    OUTPUT_KEYS = ("nose",)

    def __init__(self, frame_size, config: NoseDetectorConfig | None = None,
                 device="cuda"):
        config = config or NoseDetectorConfig()
        path = (config.nose_cascade_path
                or find_cascade("haarcascade_mcs_nose.xml",
                                "vca_nose_synthetic.xml"))
        super().__init__(frame_size, config, {"nose": path}, device=device)

    def _process_frame(self, faces, part_raw, b):
        cand = self._part_candidates(part_raw, "nose", b)
        s = self.scale_f2p
        out = []
        for (fx, fy, fw, fh) in np.asarray(faces).reshape(-1, 4):
            top = cv_round(fh * TOP_PERCENTAGE / 100)
            down = cv_round(fh * DOWN_PERCENTAGE / 100)
            side = cv_round(fw * SIDE_PERCENTAGE / 100)
            roi = Roi(cv_round((fx + side) * s), cv_round((fy + top) * s),
                      cv_round((fw - side) * s),
                      cv_round((fh - down - top) * s)).clip(
                self.part_w, self.part_h)
            out.extend(self._roi_detect(cand, roi, biggest=True))
        out = self._merge_consecutive("nose", out,
                                      self.config.euclidean_distance)
        return {"nose": self._to_original(out)}
