"""Face detector — the PyTorch port of ``nubomedia_vca_tpu/models/face.py``
(the rebuild of NuboFaceDetector).

Reference behavior (kmsfacedetect.cpp): per frame, downscale to
``width-to-process`` (default 160), gray + equalizeHist, frontal-face Haar
cascade (`haarcascade_frontalface_alt.xml`, kmsfacedetect.cpp:40,805-811),
temporal ID tracking / anti-vibration via ``Faces::track_faces``
(Faces.cpp:78-153).

The whole frame batch goes through one device pass (resize → equalize →
CascadeEngine at the working resolution → grouping) on the detector's
device; only the per-frame track association runs on the host.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..cascade.engine import _resolve_device, get_engine
from ..cascade.paths import PKG_ASSETS_DIR
from ..ops.histogram import equalize_hist
from ..ops.resize import resize_linear_exact
from .base import (DetectorConfig, GopScheduler, EventGate, bucket_pad,
                   gated_gop_mask, multi_scale_to_pyramid_factor)

# the port's bundled, byte-identical copy of OpenCV's cascade
DEFAULT_FACE_CASCADE = os.path.join(PKG_ASSETS_DIR,
                                    "haarcascade_frontalface_alt.xml")


@dataclasses.dataclass
class FaceDetectorConfig(DetectorConfig):
    """Adds the face-only knobs (kmsfacedetect.cpp:980-999):
    euclidean-distance 8, track-threshold 40, area-threshold 500."""

    euclidean_distance: int = 8
    track_threshold: int = 40
    area_threshold: int = 500
    cascade_path: str = DEFAULT_FACE_CASCADE


@dataclasses.dataclass
class TrackedFace:
    x: int
    y: int
    w: int
    h: int
    id: int

    @property
    def center(self):
        return (self.x + self.w // 2, self.y + self.h // 2)

    @property
    def area(self):
        return self.w * self.h

    def rect(self):
        return (self.x, self.y, self.w, self.h)


AREA_PERCENTAGE = 15  # Faces.cpp:4


def _distance_limit(a1: int, a2: int) -> int:
    """Size-based match distance (Faces.cpp:166-181): 8/5/3 px."""
    big = max(a1, a2)
    if big > 5000:
        return 8
    if big > 2500:
        return 5
    return 3


def _dist(c1, c2) -> int:
    return int(np.sqrt((c2[0] - c1[0]) ** 2 + (c2[1] - c1[1]) ** 2))


class FaceTracks:
    """Per-stream ID association, matching Faces::track_faces semantics
    (Faces.cpp:78-153):

    For each previous face, the nearest current detection within
    track_threshold is matched; if it moved beyond the size-based limit its
    new position is adopted (same id); if its area changed by more than 15%
    the new size is adopted at the old position; otherwise the old box is
    kept verbatim (anti-vibration). Unmatched detections get fresh ids;
    unmatched previous faces are dropped. Track state is purged after
    MAX_NUM_FPS_WITH_NO_DETECTION consecutive empty frames
    (kmsfacedetect.cpp:819-826).
    """

    def __init__(self, max_fps_without_detection: int = 1):
        self.faces: list[TrackedFace] = []
        self.next_id = 0
        self.empty_frames = 0
        self.max_empty = max_fps_without_detection

    def update(self, detections: np.ndarray, track_threshold: int) -> list[TrackedFace]:
        dets = [TrackedFace(int(x), int(y), int(w), int(h), -1)
                for (x, y, w, h) in np.asarray(detections).reshape(-1, 4)]
        if not dets:
            self.empty_frames += 1
            if self.empty_frames >= self.max_empty:
                self.faces = []
            return self.faces
        self.empty_frames = 0

        remaining = list(dets)
        out: list[TrackedFace] = []
        for prev in self.faces:
            best, best_d = None, track_threshold
            for cand in remaining:
                d = _dist(cand.center, prev.center)
                if d < best_d:
                    best, best_d = cand, d
            if best is None:
                continue  # previous face lost
            d = _dist(prev.center, best.center)
            if _distance_limit(prev.area, best.area) < d:
                best.id = prev.id
                out.append(best)
            elif AREA_PERCENTAGE < abs(prev.area - best.area) * 100 // best.area:
                out.append(TrackedFace(prev.x, prev.y, best.w, best.h, prev.id))
            else:
                out.append(prev)
            remaining.remove(best)
        for cand in remaining:
            cand.id = self.next_id
            self.next_id += 1
            out.append(cand)
        self.faces = out
        return out


class FaceDetector:
    """Batched face detection with per-stream temporal tracking, on one
    device.

    `process(gray_batch)` returns a list per frame of TrackedFace. Host
    frames are copied to `device`; resize → equalize → multiscale cascade →
    grouping run there, tracking on the host. A CUDA device runs the
    cascade's dense phase as the hand-written kernel; a CUDA request on a
    host without CUDA raises.
    """

    def __init__(self, frame_size: tuple[int, int],
                 config: FaceDetectorConfig | None = None,
                 n_streams: int = 1,
                 device: str | torch.device = "cpu"):
        self.device = _resolve_device(device)
        self.config = config or FaceDetectorConfig()
        self.frame_w, self.frame_h = frame_size
        cfg = self.config
        self._apply_geometry()
        self.gop = GopScheduler(cfg.process_x_every_4_frames)
        # face budget is unscaled (kmsfacedetect.cpp:751), unlike the parts
        self.gate = EventGate(cfg.detect_event, cfg.process_x_every_4_frames,
                              scaled=False)
        self.tracks = [FaceTracks() for _ in range(n_streams)]

    def _apply_geometry(self) -> None:
        """(Re)derive working resolution + engine from the current config.

        Reference: kmsfacedetect.cpp:282-306 — scale factor =
        width / width_to_process, full-width rows. get_engine is cached, so
        re-applying an unchanged geometry is free."""
        cfg = self.config
        self.work_w = min(cfg.width_to_process, self.frame_w)
        self.work_h = int(round(self.frame_h * self.work_w / self.frame_w))
        self.scale_back = self.frame_w / self.work_w
        self.engine = get_engine(
            cfg.cascade_path,
            (self.work_w, self.work_h),
            multi_scale_to_pyramid_factor(cfg.multi_scale_factor),
            device=self.device,
        )

    def reconfigure(self, config: FaceDetectorConfig) -> None:
        """Apply a config delta to the LIVE detector, preserving all
        temporal state (track IDs, GOP counter, event-gate budget).

        The reference's setters mutate the running element under its mutex
        (kms_face_detect_set_property, kmsfacedetect.cpp:504-582) — track
        identity survives any knob change; only the engine (a stateless
        cached object) is swapped when geometry/pyramid knobs change."""
        self.config = config
        self._apply_geometry()
        self.gop.x = int(config.process_x_every_4_frames)
        self.gate.enabled = bool(config.detect_event)
        self.gate.x = int(config.process_x_every_4_frames)

    def _tracks_for(self, stream: int) -> "FaceTracks":
        """Per-stream track state, grown on demand."""
        while stream >= len(self.tracks):
            self.tracks.append(FaceTracks())
        return self.tracks[stream]

    # device part: resize + equalize + cascade
    def _device_detect(self, gray):
        """Host frames [B,H,W] / [H,W] uint8 → the engine's raw candidates
        (boxes, valid, overflow) on the detector's device."""
        gray = torch.from_numpy(np.ascontiguousarray(gray)).to(self.device)
        if gray.ndim == 2:
            gray = gray[None]
        work = resize_linear_exact(gray, (self.work_w, self.work_h))
        work = equalize_hist(work)
        return self.engine.detect_raw(work)

    def detect_boxes(self, gray) -> list[np.ndarray]:
        """Grouped face boxes in original coordinates (no tracking).

        Grouping runs on the device (engine.group_device); only the grouped
        [B, K≤64] output crosses to the host. The batch is padded to a
        power-of-two bucket (base.bucket_pad), as in the JAX package."""
        gray, n_real = bucket_pad(np.asarray(gray) if np.ndim(gray) != 2
                                  else np.asarray(gray)[None])
        raw = self._device_detect(gray)
        if self.config.min_neighbors:
            boxes, valid, _, _ = self.engine.group_device(
                raw, self.config.min_neighbors)
        else:
            boxes, valid, _ = raw
        boxes, valid = boxes.cpu().numpy(), valid.cpu().numpy()
        out = []
        for b in range(n_real):
            grouped = boxes[b][valid[b]]
            out.append(np.rint(grouped * self.scale_back).astype(np.int32)
                       if len(grouped) else np.zeros((0, 4), np.int32))
        return out

    def process(self, gray, stream: int = 0,
                events=None) -> list[list[TrackedFace]]:
        """Full per-frame pipeline with GOP skip, event gate and tracking.
        Frames in the batch are consecutive frames of one stream.

        events: optional per-frame list; a non-None entry marks an arriving
        upstream motion event (the tracker→face chain of
        kmsfacedetect.cpp:698-707) that refuels the detect-event gate."""
        gray = np.asarray(gray)
        if gray.ndim == 2:
            gray = gray[None]
        n = gray.shape[0]
        mask = gated_gop_mask(self.gop, self.gate, n, events)
        results: list[list[TrackedFace]] = []
        det = self.detect_boxes(gray[mask]) if mask.any() else []
        det_iter = iter(det)
        tracks = self._tracks_for(stream)
        for i in range(n):
            if mask[i]:
                faces = tracks.update(next(det_iter), self.config.track_threshold)
            else:
                faces = tracks.faces
            results.append(list(faces))
        return results
