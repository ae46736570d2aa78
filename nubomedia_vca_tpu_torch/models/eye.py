"""Eye detector — the PyTorch port of ``nubomedia_vca_tpu/models/eye.py``
(the rebuild of NuboEyeDetector, kmseyedetect.cpp).

Per face (at part resolution, f2e-scaled): forehead (TOP 25%) and chin
(DOWN 40%) are cropped and the face split into halves
(kmseyedetect.cpp:31-32,979-1005); the person's RIGHT eye is sought in the
low-x half and the LEFT eye in the high-x half, each with its own cascade at
fixed pyramid factor 1.1, minNeighbors 2, minSize (20,20)
(kmseyedetect.cpp:42,991-1005). Candidates are deduped by
containment+area, eyebrow candidates above the 60% line are suppressed, at
most one eye per half survives (closest to the ROI middle), the left eye's
y is aligned to the right eye's (kmseyedetect.cpp:778-862), and temporal
anti-vibration keeps the previous box when the center moved < 7 px
(EUCLIDEAN_DIS, kmseyedetect.cpp:43,864-900).

The reference's haarcascade_mcs_{left,right}eye.xml are used when present
in a cascade search dir; otherwise the OpenCV 4 equivalents
haarcascade_{left,right}eye_2splits.xml, which the port bundles.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..cascade.paths import find_cascade
from .parts import PartDetectorBase, PartDetectorConfig, Roi, cv_round

RIGHT_EYE_CASCADE = ("haarcascade_mcs_righteye.xml",
                     "haarcascade_righteye_2splits.xml")
LEFT_EYE_CASCADE = ("haarcascade_mcs_lefteye.xml",
                    "haarcascade_lefteye_2splits.xml")

TOP_PERCENTAGE = 25    # kmseyedetect.cpp:31
DOWN_PERCENTAGE = 40   # kmseyedetect.cpp:32


@dataclasses.dataclass
class EyeDetectorConfig(PartDetectorConfig):
    euclidean_distance: int = 7
    right_cascade_path: str | None = None   # None → find_cascade probe
    left_cascade_path: str | None = None


def _center(r):
    return (r[0] + r[2] // 2, r[1] + r[3] // 2)


def _contains_pt(p, r):
    return (r[1] <= p[1] <= r[1] + r[3]) and (r[0] <= p[0] <= r[0] + r[2])


class EyeDetector(PartDetectorBase):
    FACE_MIN_NEIGHBORS = 3          # kmseyedetect.cpp:958-960
    FACE_MIN_SIZE = (30, 30)
    PART_SCALE_FACTOR = 1.1         # EYE_SCALE_FACTOR
    PART_MIN_NEIGHBORS = 2
    PART_MIN_SIZE = (20, 20)
    OUTPUT_KEYS = ("eye_right", "eye_left")

    def __init__(self, frame_size, config: EyeDetectorConfig | None = None,
                 device="cuda"):
        config = config or EyeDetectorConfig()
        super().__init__(frame_size, config, {
            "right": config.right_cascade_path
            or find_cascade(*RIGHT_EYE_CASCADE),
            "left": config.left_cascade_path
            or find_cascade(*LEFT_EYE_CASCADE),
        }, device=device)

    def _merge_current(self, face_roi_scaled, roi, eyes, right_eyes, is_left):
        """__merge_eyes_current_frame (kmseyedetect.cpp:778-862).

        face_roi_scaled: face rect in part-res coords; roi: the half ROI the
        candidates came from; eyes: candidates in part-res global coords."""
        eyes = list(eyes)
        # containment + area dedup (kmseyedetect.cpp:784-800)
        i = len(eyes) - 1
        while i > 0:
            if _contains_pt(_center(eyes[i]), eyes[i - 1]) and \
                    eyes[i][2] * eyes[i][3] < eyes[i - 1][2] * eyes[i - 1][3]:
                del eyes[i]
            elif _contains_pt(_center(eyes[i - 1]), eyes[i]) and \
                    eyes[i - 1][2] * eyes[i - 1][3] < eyes[i][2] * eyes[i][3]:
                del eyes[i - 1]
            i -= 1
        # eyebrow pass (kmseyedetect.cpp:802-822): candidates whose ROI-local
        # y puts them above the 60%-of-face line are erased back-to-front;
        # with the eye geometry (TOP 25 / DOWN 40) the test is always true,
        # so in effect only the first candidate survives. A sole left-half
        # candidate adopts the right eye's y instead of being dropped.
        y_cut = face_roi_scaled[3] * 60 // 100
        for idx in reversed(range(len(eyes))):
            local_y = eyes[idx][1] - roi.y
            if local_y < y_cut:
                if idx == 0 and len(eyes) == 1:
                    if is_left and right_eyes:
                        e = eyes[0]
                        eyes[0] = (e[0], right_eyes[0][1], e[2], e[3])
                else:
                    del eyes[idx]
        # safety: at most one per half, closest to the ROI middle
        if len(eyes) > 1:
            mid = (roi.x + roi.w // 2, roi.y + roi.h // 2)
            eyes = [min(eyes, key=lambda e: np.hypot(
                _center(e)[0] - mid[0], _center(e)[1] - mid[1]))]
        # left-eye y aligned to the right eye's (kmseyedetect.cpp:855-861)
        if is_left and eyes and right_eyes:
            e = eyes[0]
            eyes[0] = (e[0], right_eyes[0][1], e[2], e[3])
        return eyes

    def _process_frame(self, faces, part_raw, b):
        cand_r = self._part_candidates(part_raw, "right", b)
        cand_l = self._part_candidates(part_raw, "left", b)
        s = self.scale_f2p
        out_r, out_l = [], []
        for (fx, fy, fw, fh) in np.asarray(faces).reshape(-1, 4):
            rx, ry = cv_round(fx * s), cv_round(fy * s)
            rw, rh = cv_round(fw * s), cv_round(fh * s)
            top = cv_round(rh * TOP_PERCENTAGE / 100)
            down = cv_round(rh * DOWN_PERCENTAGE / 100)
            half = Roi(rx, ry + top, rw // 2, rh - top - down).clip(
                self.part_w, self.part_h)
            half_l = Roi(rx + rw // 2, ry + top, rw // 2, rh - top - down
                         ).clip(self.part_w, self.part_h)
            face_scaled = (rx, ry, rw, rh)
            r_eyes = self._roi_detect(cand_r, half, biggest=False)
            r_eyes = self._merge_current(face_scaled, half, r_eyes, [], False)
            l_eyes = self._roi_detect(cand_l, half_l, biggest=False)
            l_eyes = self._merge_current(face_scaled, half_l, l_eyes, r_eyes, True)
            out_r.extend(r_eyes)
            out_l.extend(l_eyes)
        eu = self.config.euclidean_distance
        out_r = self._merge_consecutive("right", out_r, eu)
        out_l = self._merge_consecutive("left", out_l, eu)
        return {
            "eye_right": self._to_original(out_r),
            "eye_left": self._to_original(out_l),
        }
