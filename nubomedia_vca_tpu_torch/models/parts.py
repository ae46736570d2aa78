"""ROI-scoped part detection — the shared core of the eye / mouth / nose
detectors; the PyTorch port of ``nubomedia_vca_tpu/models/parts.py``.

Reference pattern (kmseyedetect.cpp:915-1102 and siblings): per frame,
detect faces on a 160-wide image, then run a part cascade over a
face-relative ROI crop of the part-resolution image, then merge results
temporally.

As in the JAX package, each part cascade runs ONCE over the whole
part-resolution frame batch on the device, and candidate windows are then
assigned to face ROIs by containment on the host (the JAX package's
``tests/test_part_golden_parity.py`` measures this against OpenCV on the
reference's ROI crops). The host logic is a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cascade.engine import _resolve_device, get_engine
from ..ops.grouping import group_rectangles_np
from ..utils.tracing import active, count, trace
from .base import (DetectorConfig, GopScheduler, EventGate, StagingRing,
                   gated_gop_mask, multi_scale_to_pyramid_factor,
                   select_frames)
from .face import DEFAULT_FACE_CASCADE


def cv_round(x):
    return int(np.rint(x))


@dataclasses.dataclass
class PartDetectorConfig(DetectorConfig):
    """Common part-detector knobs. width_to_process defaults to 320
    (kmseyedetect.cpp:24-25); the face pass runs at 160 like the reference's
    internal face cascade."""

    width_to_process: int = 320
    face_cascade_path: str = DEFAULT_FACE_CASCADE
    face_width: int = 160
    euclidean_distance: int = 7
    # keep previous part boxes across up to this many consecutive empty
    # frames before purging (MAX_NUM_FPS_WITH_NO_DETECTION: 1 for
    # eye/mouth/nose — kmseyedetect.cpp:41)
    max_fps_without_detection: int = 1


class Roi:
    __slots__ = ("x", "y", "w", "h")

    def __init__(self, x, y, w, h):
        self.x, self.y, self.w, self.h = int(x), int(y), int(w), int(h)

    def clip(self, W, H):
        x0 = max(0, self.x); y0 = max(0, self.y)
        x1 = min(W, self.x + self.w); y1 = min(H, self.y + self.h)
        return Roi(x0, y0, max(0, x1 - x0), max(0, y1 - y0))

    def contains_box(self, b):
        return (b[0] >= self.x and b[1] >= self.y
                and b[0] + b[2] <= self.x + self.w
                and b[1] + b[3] <= self.y + self.h)


class _StreamState:
    """Per-stream temporal state: GOP counter, event-gate budget and the
    anti-vibration merge state (the x:.._prev/_er/_el counters of
    kmseyedetect.cpp:1034-1064, scoped per stream)."""

    __slots__ = ("gop", "gate", "prev", "empty_count")

    def __init__(self, config: PartDetectorConfig):
        self.gop = GopScheduler(config.process_x_every_4_frames)
        self.gate = EventGate(config.detect_event,
                              config.process_x_every_4_frames)
        self.prev: dict[str, list] = {}
        self.empty_count: dict[str, int] = {}


class PartDetectorBase:
    """Shared machinery: batched face pass + batched part pass on one
    device + per-ROI candidate assignment on the host. Subclasses define
    ROI geometry and merge rules. Engines run on the card unless the caller
    asks for another device; a CUDA request on a host without CUDA
    raises."""

    # per-module cascade parameters (reference call sites; see models/*.py)
    FACE_MIN_NEIGHBORS = 2
    FACE_MIN_SIZE = (3, 3)
    PART_SCALE_FACTOR = 1.1
    PART_MIN_NEIGHBORS = 3
    PART_MIN_SIZE = (0, 0)

    def __init__(self, frame_size: tuple[int, int], config: PartDetectorConfig,
                 part_cascades: dict[str, str],
                 device: str | torch.device = "cuda"):
        self.device = _resolve_device(device)
        self.config = config
        self.frame_w, self.frame_h = frame_size
        self._part_cascade_paths = dict(part_cascades)
        self._apply_geometry()
        self._ring = StagingRing(self.device)
        self._streams: dict[int, _StreamState] = {}
        self._active = self._stream_state(0)

    # ------------------------------------------------------ per-stream state
    def _stream_state(self, stream: int) -> _StreamState:
        st = self._streams.get(stream)
        if st is None:
            st = _StreamState(self.config)
            self._streams[stream] = st
        return st

    # views onto the ACTIVE stream's state (stream 0 until a
    # process(..., stream=) call selects another)
    @property
    def gop(self) -> GopScheduler:
        return self._active.gop

    @property
    def gate(self) -> EventGate:
        return self._active.gate

    @property
    def _prev(self) -> dict:
        return self._active.prev

    @property
    def _empty_count(self) -> dict:
        return self._active.empty_count

    def _apply_geometry(self) -> None:
        """(Re)derive face/part resolutions + engines from the current
        config (get_engine is cached; unchanged geometry costs nothing)."""
        config = self.config
        # face resolution (o2f) and part resolution (o2p)
        self.face_w = min(config.face_width, self.frame_w)
        self.face_h = int(round(self.frame_h * self.face_w / self.frame_w))
        self.part_w = min(config.width_to_process, self.frame_w)
        self.part_h = int(round(self.frame_h * self.part_w / self.frame_w))
        self.scale_f2p = self.part_w / self.face_w     # face-res → part-res
        self.scale_p2o = self.frame_w / self.part_w    # part-res → original

        self.face_engine = get_engine(
            config.face_cascade_path,
            (self.face_w, self.face_h),
            multi_scale_to_pyramid_factor(config.multi_scale_factor),
            min_size=self.FACE_MIN_SIZE, device=self.device,
        )
        self.part_engines = {
            name: get_engine(
                path, (self.part_w, self.part_h),
                self.PART_SCALE_FACTOR, min_size=self.PART_MIN_SIZE,
                device=self.device,
            )
            for name, path in self._part_cascade_paths.items()
        }

    def reconfigure(self, config: PartDetectorConfig) -> None:
        """Apply a config delta to the LIVE detector, preserving temporal
        state (anti-vibration boxes, empty-frame counters, GOP counter,
        event-gate budget), as the reference's setters do."""
        self.config = config
        self._apply_geometry()
        for st in self._streams.values():
            st.gop.x = int(config.process_x_every_4_frames)
            st.gate.enabled = bool(config.detect_event)
            st.gate.x = int(config.process_x_every_4_frames)

    # ------------------------------------------------------------ device part
    def _device_pass(self, gray):
        """Host frames [B,H,W] / [H,W] uint8, or a `base.FrameSelection`
        of them → (face_raw, part_raw) as host arrays, for the batch
        padded to a power-of-two bucket as in the JAX package.

        The frames reach the device through the detector's staging ring
        (`base.StagingRing`), which resizes and equalizes them to both
        resolutions there; then both are detected, face candidates
        minNeighbors-grouped and part candidates compacted to the
        engine's RAW_GROUP_CAP, so only O(detections) arrays cross to the
        host, never the padded window capacity."""
        (face_img, part_img), _ = self._ring.stage(
            select_frames(gray), [(self.face_w, self.face_h),
                                  (self.part_w, self.part_h)])
        face_raw = self.face_engine.group_device(
            self.face_engine.detect_raw(face_img), self.FACE_MIN_NEIGHBORS)
        part_raw = {name: eng.compact_raw(eng.detect_raw(part_img))
                    for name, eng in self.part_engines.items()}
        with trace("vca.filter.fetch"):
            return (tuple(t.cpu().numpy() for t in face_raw),
                    {name: tuple(t.cpu().numpy() for t in raw)
                     for name, raw in part_raw.items()})

    def _faces_from_raw(self, face_raw, b: int) -> np.ndarray:
        boxes, valid, _, _ = face_raw
        return boxes[b][valid[b]]

    def _part_candidates(self, part_raw, name: str, b: int) -> np.ndarray:
        boxes, valid, _ = part_raw[name]
        return boxes[b][valid[b]]

    def _roi_detect(self, candidates: np.ndarray, roi: Roi,
                    biggest: bool) -> list[tuple[int, int, int, int]]:
        """Group candidates inside a ROI; optionally keep only the biggest
        (the reference's FIND_BIGGEST usage)."""
        inside = [c for c in candidates if roi.contains_box(c)]
        if not inside:
            return []
        grouped = group_rectangles_np(np.array(inside), self.PART_MIN_NEIGHBORS)
        out = [tuple(int(v) for v in g) for g in grouped]
        if biggest and out:
            out = [max(out, key=lambda r: r[2] * r[3])]
        return out

    def _merge_consecutive(self, key: str, new: list, euclidean: int) -> list:
        """Anti-vibration merge (kmseyedetect.cpp:864-900 and siblings):
        keep the previous box when its center moved less than `euclidean`.

        Empty-frame persistence (kmseyedetect.cpp:1034-1064): with no new
        detections, the previously stored boxes are re-emitted unchanged
        for up to max_fps_without_detection consecutive frames, then
        purged."""
        prev = self._prev.get(key, [])
        if not new:
            cnt = self._empty_count.get(key, 0)
            if cnt < self.config.max_fps_without_detection:
                self._empty_count[key] = cnt + 1
                return list(prev)      # keep previous boxes, state untouched
            self._empty_count[key] = 0
            self._prev[key] = []
            return []
        self._empty_count[key] = 0
        res = []
        remaining = list(new)
        for p in prev:
            pc = (p[0] + p[2] // 2, p[1] + p[3] // 2)
            hit = None
            for c in remaining:
                cc = (c[0] + c[2] // 2, c[1] + c[3] // 2)
                if np.hypot(cc[0] - pc[0], cc[1] - pc[1]) < euclidean:
                    hit = c
                    break
            if hit is not None:
                res.append(p)
                remaining.remove(hit)
        res.extend(remaining)
        self._prev[key] = res
        return res

    def _to_original(self, rects, offset_x=0, offset_y=0):
        """ROI-local → original pixels like transform_2_global_coordinates
        (kmseyedetect.cpp:902-913): x=(roi.x+x)*scale, w=(w-1)*scale."""
        s = self.scale_p2o
        return [
            (cv_round((offset_x + x) * s), cv_round((offset_y + y) * s),
             cv_round((w - 1) * s), cv_round((h - 1) * s))
            for (x, y, w, h) in rects
        ]

    # ------------------------------------------------------------- host logic
    def process(self, gray, face_boxes=None, stream: int = 0):
        """gray [B?,H,W]; face_boxes: optional per-frame face boxes in
        ORIGINAL coordinates (the detect-event path, where an upstream face
        detector feeds boxes; kmseyedetect.cpp:680-724). Returns a list per
        frame of dicts of named detections in original coordinates.

        `stream` selects the per-stream temporal state; frames in one call
        are consecutive frames of that stream."""
        with trace("vca.filter.process"):
            self._active = self._stream_state(stream)
            gray = np.asarray(gray)
            if gray.ndim == 2:
                gray = gray[None]
            n = gray.shape[0]
            count("vca.filter.frames", n)
            events = face_boxes if self.gate.enabled else None
            mask = gated_gop_mask(self.gop, self.gate, n, events)
            if not mask.any():
                return [self._idle_result() for _ in range(n)]
            sel = select_frames(gray, mask)
            n_real = len(sel.index)
            face_raw, part_raw = self._device_pass(sel)
            if active():
                # frames on which any engine of the call overflowed
                overflow = face_raw[3][:n_real].copy()
                for raw in part_raw.values():
                    overflow |= raw[2][:n_real]
                count("vca.filter.frames_detected", n_real)
                count("vca.engine.overflow_frames", int(overflow.sum()))
            with trace("vca.filter.track"):
                results = []
                bi = 0
                for i in range(n):
                    if not mask[i]:
                        results.append(self._idle_result())
                        continue
                    supplied = None
                    if self.gate.enabled:
                        # with detect-event the faces come from the LAST
                        # received event and persist for the whole budget
                        # window (kmseyedetect.cpp:954-961)
                        supplied = self.gate.pending_payload
                    elif face_boxes is not None and face_boxes[i] is not None:
                        supplied = face_boxes[i]
                    if supplied is not None:
                        # event-supplied faces are in original coords →
                        # face-res
                        faces = np.rint(
                            np.asarray(supplied).reshape(-1, 4)
                            * (self.face_w / self.frame_w)).astype(np.int32)
                    else:
                        faces = self._faces_from_raw(face_raw, bi)
                    results.append(self._process_frame(faces, part_raw, bi))
                    bi += 1
            return results

    OUTPUT_KEYS: tuple[str, ...] = ()

    def _idle_result(self):
        return {k: [] for k in self.OUTPUT_KEYS}

    def _process_frame(self, faces, part_raw, b):  # pragma: no cover - abstract
        raise NotImplementedError
