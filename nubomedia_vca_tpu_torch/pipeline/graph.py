"""Filter graph — the pipeline-chaining layer.

The reference chains filters through GStreamer: a face detector pushes
custom-downstream events with face boxes, and eye/mouth/nose detectors with
``detect-event=1`` idle until those arrive, then process 10 frames
(SURVEY.md §2.4.8; kmseyedetect.cpp:680-764). Here the same dataflow is a
typed event bus over an ordered list of filters, all sharing one batched
frame stream.

A copy of ``nubomedia_vca_tpu/pipeline/graph.py``: the models it wraps
are the port's, built by the caller on their device.
"""

from __future__ import annotations

import numpy as np

from .events import Detection, DetectionEvent


class FilterNode:
    """Wraps a detector model as a pipeline element.

    kind: 'face' | 'eye' | 'mouth' | 'nose' | 'ear' | 'tracker'
    consumes: event types that gate/feed this filter (e.g. eye consumes
    'face' boxes). emits: detection type names it produces.
    """

    def __init__(self, name, model, kind, consumes=(), emits=()):
        self.name = name
        self.model = model
        self.kind = kind
        self.consumes = set(consumes)
        self.emits = tuple(emits)

    def _incoming_boxes(self, n, incoming):
        """Per-frame upstream boxes of the consumed types (None = no
        event arrived for that frame)."""
        out = []
        for i in range(n):
            ev = incoming[i] if incoming else None
            bx = ev.boxes(self.consumes) if ev is not None else None
            out.append(np.array(bx) if bx else None)
        return out

    def process(self, frames, pts, incoming: list[DetectionEvent]):
        n = frames.shape[0]
        if self.kind == "face":
            # motion-gated face detection (kmsfacedetect.cpp:698-707):
            # upstream (tracker) events refuel the face detect-event gate
            events = (self._incoming_boxes(n, incoming)
                      if self.consumes else None)
            per_frame = self.model.process(frames, events=events)
            out = []
            for i, faces in enumerate(per_frame):
                dets = tuple(Detection("face", f.x, f.y, f.w, f.h, f.id)
                             for f in faces)
                out.append(DetectionEvent(self.name, int(pts[i]), dets))
            return out
        if self.kind == "tracker":
            per_frame = self.model.process(frames)
            return [
                DetectionEvent(self.name, int(pts[i]), tuple(
                    Detection("tracker", x, y, w, h)
                    for (x, y, w, h) in blobs))
                for i, blobs in enumerate(per_frame)
            ]
        # part detectors: face boxes flow in per frame; the model's own
        # EventGate handles budget/persistence (models/base.gated_gop_mask)
        face_boxes = (self._incoming_boxes(n, incoming)
                      if self.consumes else None)
        per_frame = self.model.process(frames, face_boxes=face_boxes)
        events = []
        for i, res in enumerate(per_frame):
            dets = []
            for tname, rects in res.items():
                dets.extend(Detection(tname, *r[:4]) for r in rects)
            events.append(DetectionEvent(self.name, int(pts[i]), tuple(dets)))
        return events


class VcaPipeline:
    """Ordered filter chain over one frame stream. Events from each filter
    are visible to all downstream filters of the same batch (the GstEvent
    serialized-downstream semantics)."""

    def __init__(self):
        self.nodes: list[FilterNode] = []

    def add(self, node: FilterNode) -> "VcaPipeline":
        self.nodes.append(node)
        return self

    def process(self, frames, pts=None) -> dict[str, list[DetectionEvent]]:
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        n = frames.shape[0]
        if pts is None:
            pts = np.arange(n, dtype=np.int64)
        out: dict[str, list[DetectionEvent]] = {}
        downstream: list[DetectionEvent] | None = None
        for node in self.nodes:
            events = node.process(frames, pts, downstream)
            out[node.name] = events
            if downstream is None:
                downstream = events
            else:
                # merge: downstream filters see prior detections per frame
                downstream = [
                    DetectionEvent(
                        ev_prev.source, ev_prev.pts,
                        ev_prev.detections + ev_new.detections)
                    for ev_prev, ev_new in zip(downstream, events)
                ]
        return out
