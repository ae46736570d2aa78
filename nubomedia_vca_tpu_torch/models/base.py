"""Shared detector machinery: config knobs, GOP frame-skip scheduling, and
event-gated processing budgets.

A copy of ``nubomedia_vca_tpu/models/base.py`` (numpy only).

Every reference element exposes the same GObject knob set
(`kmsfacedetect.cpp:1043-1102`): view toggle, detect-event gating,
width-to-process, process-x-every-4-frames, multi-scale-factor,
activate-events / events-ms, overlay image. Configs here mirror those names
and ranges 1:1 so the api/ layer can map RPC setters directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def multi_scale_to_pyramid_factor(multi_scale_factor: int) -> float:
    """User knob s (5..50, default 25) → pyramid factor 1 + s/100
    (`kmsfacedetect.cpp:142`)."""
    return 1.0 + multi_scale_factor / 100.0


@dataclasses.dataclass
class DetectorConfig:
    """Common knobs (names mirror the GObject properties)."""

    view: int = 1                      # "view-faces"/"view-eyes"/...: draw overlay
    detect_event: int = 0              # 1 = idle until an upstream event arrives
    send_meta_data: int = 0
    width_to_process: int = 160        # 160/320/480/640 working width
    process_x_every_4_frames: int = 4  # GOP-4 frame skip policy
    multi_scale_factor: int = 25       # pyramid = 1 + s/100
    activate_events: int = 0           # rate-limited server events
    events_ms: int = 30001
    min_neighbors: int = 3


class GopScheduler:
    """The reference's frame-skip policy (`kmsfacedetect.cpp:797-801,827-828`):
    within each group of 4 (num_frame 1..4), process frames 1..x — EXCEPT
    x == 2, which the reference special-cases to ALTERNATING frames
    (``2 == x && 1 == num_frame % 2`` → frames 1 and 3)."""

    def __init__(self, process_x_every_4: int = 4):
        self.x = int(process_x_every_4)
        self.counter = 0

    def should_process(self) -> bool:
        num_frame = (self.counter % 4) + 1
        ok = (num_frame % 2 == 1) if self.x == 2 else (num_frame <= self.x)
        self.counter += 1
        return ok

    def mask(self, n: int) -> np.ndarray:
        """Vector form: processing mask for the next n frames."""
        if n <= 0:
            raise ValueError("empty frame batch")
        num_frame = (self.counter + np.arange(n)) % 4 + 1
        self.counter += n
        if self.x == 2:
            return num_frame % 2 == 1
        return num_frame <= self.x


class EventGate:
    """detect-event gating (`kmsfacedetect.cpp:744-751`,
    `kmseyedetect.cpp:726-764`): when enabled, the filter idles until an
    upstream event arrives, then processes a frame budget —
    NUM_FRAMES_TO_PROCESS for the face element (unscaled,
    kmsfacedetect.cpp:751), NUM_FRAMES_TO_PROCESS/(5-x) for the part
    elements (kmseyedetect.cpp:759-761). The budget is decremented ONLY on
    GOP-processed frames (kmsfacedetect.cpp:800 / kmseyedetect.cpp:948);
    use `gated_gop_mask` for the exact per-frame schedule."""

    NUM_FRAMES_TO_PROCESS = 10

    def __init__(self, enabled: bool, process_x_every_4: int = 4,
                 scaled: bool = True):
        self.enabled = bool(enabled)
        self.budget = 0
        self.x = int(process_x_every_4)
        self.scaled = scaled
        self.pending_payload = None

    def feed_event(self, payload=None) -> None:
        self.budget = (self.NUM_FRAMES_TO_PROCESS // (5 - self.x)
                       if self.scaled else self.NUM_FRAMES_TO_PROCESS)
        if payload is not None:
            self.pending_payload = payload

    def should_process(self) -> bool:
        if not self.enabled:
            return True
        if self.budget > 0:
            self.budget -= 1
            return True
        return False


def gated_gop_mask(gop: GopScheduler, gate: EventGate, n: int,
                   events=None) -> np.ndarray:
    """Exact per-frame processing schedule of the reference
    (kmsfacedetect.cpp:793-800):

    per frame: an arriving event refuels the gate budget; with the gate
    enabled and no event and no budget the frame is IDLE (the GOP counter
    does not even advance — the reference returns before num_frame++);
    otherwise the GOP policy decides, and the gate budget is consumed only
    for frames the GOP actually processes.

    events: optional per-frame list; a non-None entry means an upstream
    event arrived with that payload (face boxes for the part detectors,
    anything truthy for the motion→face gate).
    """
    mask = np.zeros(n, bool)
    for i in range(n):
        ev = events[i] if events is not None else None
        if ev is not None and gate.enabled:
            gate.feed_event(ev)
        if gate.enabled and ev is None and gate.budget <= 0:
            continue  # idle frame: no GOP advance, no budget use
        if gop.should_process():
            mask[i] = True
            if gate.enabled:
                gate.budget -= 1
    return mask


def bucket_pad(gray: np.ndarray):
    """Pad a frame batch to the next power-of-two size (repeating the
    first frame) → (padded, n_real).

    Gated/GOP-masked processing produces sub-batches of every size 1..B;
    bucketing bounds the set of batch shapes the device sees to log2(B)
    sizes; callers slice results [:n_real].
    """
    gray = np.asarray(gray)
    n = gray.shape[0]
    if n == 0:
        return gray, 0
    m = 1 << (n - 1).bit_length()
    if m != n:
        pad = np.repeat(gray[:1], m - n, axis=0)
        gray = np.concatenate([gray, pad], axis=0)
    return gray, n
