"""Ear detector — the PyTorch port of ``nubomedia_vca_tpu/models/ear.py``
(the rebuild of NuboEarDetector, kmseardetect.cpp).

The reference detects PROFILE faces (haarcascade_profileface.xml,
kmseardetect.cpp:29), then looks for the ear in a side ROI of the face
(TOP/DOWN 20% cropped, outer half + EXTRA_ROI 50 px, kmseardetect.cpp:
684-707); the right side is handled by horizontally flipping the image and
re-running (kmseardetect.cpp:796-803). Both `face_profile` and `ear`
detections are emitted (kmseardetect.cpp:195-280). No event gating
(detect_event stored but unused in processing). Ear anti-vibration:
MAX_NUM_FPS_WITH_NO_DETECTION = 4.

Device design, as in the JAX package: the frames are uploaded once and
flipped on the device, and the profile and ear cascade passes run batched
over [normal, flipped]. Right-side detections are mirrored back to true
image coordinates.

Cascades: the reference's mcs ear models are used when present in a
cascade search dir (cascade/paths.py); otherwise the port's bundled copy of
the JAX package's trained ``vca_ear_synthetic.xml``. Defaults pair
coherently: a real mcs ear model pairs with the real profile cascade
(``haarcascade_profileface.xml``, bundled); the synthetic ear model pairs
with the synthetic profile cascade (``vca_profileface_synthetic.xml``,
bundled), since the real profile cascade, trained on photographs, does not
fire on the cartoon frames the synthetic ear model is trained for.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..cascade.paths import find_cascade
from ..ops.histogram import equalize_hist
from ..ops.resize import resize_linear_exact
from .parts import PartDetectorBase, PartDetectorConfig, Roi, cv_round

# probed in order: the real profile model, then the trained synthetic one
PROFILE_CASCADES = ("haarcascade_profileface.xml",
                    "vca_profileface_synthetic.xml")
# mcs models (the reference's exact files) first, then the trained
# substitute
EAR_CASCADES = ("haarcascade_mcs_rightear.xml", "haarcascade_mcs_leftear.xml",
                "vca_ear_synthetic.xml")

TOP_PERCENTAGE = 20    # kmseardetect.cpp:38
DOWN_PERCENTAGE = 20   # kmseardetect.cpp:39
EXTRA_ROI = 50         # kmseardetect.cpp:51


@dataclasses.dataclass
class EarDetectorConfig(PartDetectorConfig):
    euclidean_distance: int = 7
    face_cascade_path: str | None = None   # None → PROFILE_CASCADES probe
    ear_cascade_path: str | None = None
    max_fps_without_detection: int = 4   # kmseardetect.cpp:48


class EarDetector(PartDetectorBase):
    FACE_MIN_NEIGHBORS = 2          # kmseardetect.cpp:656-659
    FACE_MIN_SIZE = (3, 3)
    PART_SCALE_FACTOR = 1.1         # EAR_SCALE_FACTOR, kmseardetect.cpp:44
    PART_MIN_NEIGHBORS = 3
    PART_MIN_SIZE = (1, 1)
    OUTPUT_KEYS = ("face_profile", "ear")

    def __init__(self, frame_size, config: EarDetectorConfig | None = None,
                 device="cuda"):
        config = config or EarDetectorConfig()
        ear_path = config.ear_cascade_path or find_cascade(*EAR_CASCADES)
        if config.face_cascade_path is None:
            synth_ear = (ear_path is not None and os.path.basename(ear_path)
                         == "vca_ear_synthetic.xml")
            probe = (("vca_profileface_synthetic.xml",) + PROFILE_CASCADES
                     if synth_ear else PROFILE_CASCADES)
            config.face_cascade_path = find_cascade(*probe)
        if config.face_cascade_path is None:
            raise ValueError(
                "EarDetector found no profile-face cascade; install OpenCV "
                "haarcascades or pass face_cascade_path")
        cascades = {"ear": ear_path} if ear_path else {}
        self._n_real = 0
        self._face_raw = None
        super().__init__(frame_size, config, cascades, device=device)

    def _device_pass(self, gray):
        """Both orientations in one batched pass: host frames [B,H,W] are
        uploaded once, flipped on the device and run as [2B] = [normal...,
        flipped...]; only the grouped faces and compacted ear candidates
        come back to the host."""
        gray = torch.from_numpy(np.ascontiguousarray(gray)).to(self.device)
        if gray.ndim == 2:
            gray = gray[None]
        both = torch.cat([gray, torch.flip(gray, dims=(2,))])
        face_img = equalize_hist(
            resize_linear_exact(both, (self.face_w, self.face_h)))
        part_img = equalize_hist(
            resize_linear_exact(both, (self.part_w, self.part_h)))
        face_raw = self.face_engine.group_device(
            self.face_engine.detect_raw(face_img), self.FACE_MIN_NEIGHBORS)
        part_raw = {name: eng.compact_raw(eng.detect_raw(part_img))
                    for name, eng in self.part_engines.items()}
        self._n_real = gray.shape[0]
        return (tuple(t.cpu().numpy() for t in face_raw),
                {name: tuple(t.cpu().numpy() for t in raw)
                 for name, raw in part_raw.items()})

    def _side_rois(self, faces):
        """Side ROI per profile face (kmseardetect.cpp:684-707), in part-res
        coordinates of the (possibly flipped) image."""
        s = self.scale_f2p
        rois = []
        for (fx, fy, fw, fh) in np.asarray(faces).reshape(-1, 4):
            top = cv_round(fh * TOP_PERCENTAGE / 100)
            down = cv_round(fh * DOWN_PERCENTAGE / 100)
            x = cv_round((fx + fw // 2) * s)
            y = cv_round((fy + top) * s)
            h = cv_round((fh - down) * s)
            w = cv_round((fw / 2) * s) + EXTRA_ROI
            rois.append(Roi(x, y, w, h).clip(self.part_w, self.part_h))
        return rois

    def _side_detections(self, part_raw, idx: int, flipped: bool):
        """Profile faces and ears of one orientation (device batch index
        idx), in true image coordinates: the flipped side's boxes are
        mirrored back."""
        side_faces = self._faces_from_raw(self._face_raw, idx)
        faces = []
        for (fx, fy, fw, fh) in side_faces:
            tx = self.face_w - fx - fw if flipped else fx
            # v * frame_w / face_w in float32, as the JAX package computes
            # it on its int32 device boxes
            faces.append(tuple(
                cv_round(np.float32(v * self.frame_w)
                         / np.float32(self.face_w))
                for v in (tx, fy, fw, fh)))
        ears = []
        if "ear" in self.part_engines:
            cand = self._part_candidates(part_raw, "ear", idx)
            for roi in self._side_rois(side_faces):
                found = self._roi_detect(cand, roi, biggest=True)
                for (x, y, w, h) in self._to_original(found):
                    if flipped:
                        x = self.frame_w - x - w
                    ears.append((x, y, w, h))
        return faces, ears

    def _process_frame(self, faces, part_raw, b):
        """Frame b's profile faces and ears: the normal orientation at
        index b of the device batch, the flipped one at b + n_real."""
        left_faces, left_ears = self._side_detections(part_raw, b, False)
        right_faces, right_ears = self._side_detections(
            part_raw, b + self._n_real, True)
        ears = self._merge_consecutive(
            "ear", left_ears + right_ears, self.config.euclidean_distance)
        return {"face_profile": left_faces + right_faces, "ear": ears}

    def process(self, gray, face_boxes=None, stream: int = 0):
        """gray [B?,H,W] → per-frame {"face_profile", "ear"} lists in
        original coordinates. The ear module ignores detect-event gating
        (reference parity: detect_event is stored but unused in
        processing), and its batch is not bucket-padded, as in the JAX
        package."""
        self._active = self._stream_state(stream)
        gray = np.asarray(gray)
        if gray.ndim == 2:
            gray = gray[None]
        n = gray.shape[0]
        mask = self.gop.mask(n)
        if not mask.any():
            return [self._idle_result() for _ in range(n)]
        self._face_raw, part_raw = self._device_pass(gray[mask])
        results = []
        bi = 0
        for i in range(n):
            if not mask[i]:
                results.append(self._idle_result())
                continue
            results.append(self._process_frame(None, part_raw, bi))
            bi += 1
        return results
