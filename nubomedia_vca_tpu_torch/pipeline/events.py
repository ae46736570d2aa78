"""Typed detection events — the replacement for the reference's two event
channels (SURVEY.md §2.4.9):

  (a) custom-downstream GstEvents carrying one GstStructure per detection
      `{type, x, y, width, height}` plus the frame pts
      (`kms_face_send_event`, kmsfacedetect.cpp:179-249) — here a
      `DetectionEvent` flowing between pipeline filters;
  (b) rate-limited server signals carrying the wire string
      "x:..,y:..,width:..,height:..;" (kmsfacedetect.cpp:228-246) — here
      `to_wire_string` / `parse_wire_string`, byte-compatible with the
      format NuboFaceDetectorImpl.cpp:39-129 parses.

A copy of ``nubomedia_vca_tpu/pipeline/events.py``.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class Detection:
    type: str            # "face", "eye_left", "mouth", "face_profile", ...
    x: int
    y: int
    width: int
    height: int
    id: int | None = None


@dataclasses.dataclass
class DetectionEvent:
    """One frame's detections flowing downstream between filters."""

    source: str                       # emitting filter name
    pts: int                          # frame pts (ns)
    detections: tuple[Detection, ...]

    def boxes(self, types: set[str] | None = None):
        return [
            (d.x, d.y, d.width, d.height) for d in self.detections
            if types is None or d.type in types
        ]


def to_wire_string(dets) -> str:
    """Serialize like the reference's GLib signal payload:
    "x:1,y:2,width:3,height:4;x:...;" (gstnubotracker.cpp:393-399)."""
    return "".join(
        f"x:{d.x},y:{d.y},width:{d.width},height:{d.height};" for d in dets
    )


def parse_wire_string(s: str, type_name: str = "object") -> list[Detection]:
    """Parse the wire format the way the server Impl does (split on ';' then
    ',' then ':', NuboFaceDetectorImpl.cpp:39-129)."""
    out = []
    for item in s.split(";"):
        if not item.strip():
            continue
        fields = {}
        for kv in item.split(","):
            k, _, v = kv.partition(":")
            fields[k.strip()] = int(v)
        out.append(Detection(type_name, fields.get("x", 0), fields.get("y", 0),
                             fields.get("width", 0), fields.get("height", 0)))
    return out


class EventRateLimiter:
    """events-ms rate limiting for server events (default 30001 ms,
    kmsfacedetect.cpp:35,228-246)."""

    def __init__(self, events_ms: int = 30001, clock=time.monotonic):
        self.events_ms = events_ms
        self._clock = clock
        self._last = -float("inf")

    def ready(self) -> bool:
        now = self._clock() * 1000.0
        if now - self._last > self.events_ms:
            self._last = now
            return True
        return False
