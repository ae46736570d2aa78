"""Shared detector machinery: config knobs, GOP frame-skip scheduling,
event-gated processing budgets, and the staging ring through which the
face and part detectors upload their frames.

Apart from the ring (`FrameSelection`, `StagingRing`), a copy of
``nubomedia_vca_tpu/models/base.py``.

Every reference element exposes the same GObject knob set
(`kmsfacedetect.cpp:1043-1102`): view toggle, detect-event gating,
width-to-process, process-x-every-4-frames, multi-scale-factor,
activate-events / events-ms, overlay image. Configs here mirror those names
and ranges 1:1 so the api/ layer can map RPC setters directly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.histogram import equalize_hist
from ..ops.resize import resize_linear_exact
from ..utils.tracing import count, trace


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


# host bytes a staging slot holds: 8 frames of 720p luma
STAGE_SLOT_BYTES = 8_000_000


class FrameSelection(NamedTuple):
    """Host frames and the ones among them to detect, in order: what a
    detector's device pass takes instead of a gathered copy."""

    frames: np.ndarray      # [B, H, W], any strides (``clip[::-1]`` too)
    index: np.ndarray       # indices into `frames`


def select_frames(gray, mask=None) -> FrameSelection:
    """Host frames [B,H,W] / [H,W] (or a selection, returned as it is)
    → the selection of the frames `mask` marks (every frame without one)."""
    if isinstance(gray, FrameSelection):
        return gray
    gray = np.asarray(gray)
    if gray.ndim == 2:
        gray = gray[None]
    index = (np.arange(gray.shape[0]) if mask is None
             else np.flatnonzero(mask))
    return FrameSelection(gray, index)


class StagingRing:
    """A detector's upload: two host slots of `STAGE_SLOT_BYTES`, pinned
    when the device is CUDA, through which the selected frames go to the
    device chunk by chunk.

    Each frame is copied once, from wherever it lies, into a slot; the
    slot's copy to the device is asynchronous and runs while the host
    fills the other slot. A slot is overwritten only after its last copy
    ended (the one wait the ring adds). On the device the batch is
    resized whole, once per size (resizing each chunk as it lands issues
    ~15 ops a chunk and size, whose host time exceeds the device time it
    would hide), bucket-padded, the padding rows repeating the first frame
    as `bucket_pad` does, and equalized, so the result is bit for bit that
    of ``equalize_hist(resize_linear_exact(from_numpy(bucket_pad(
    gray[mask]))))``.
    On the CPU the slots are plain tensors and the same steps run
    synchronously. The slots are allocated at the first call, and again
    when the frame shape or dtype changes."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.slots: list[torch.Tensor] = []
        self._host: list[np.ndarray] = []     # numpy views of the slots
        self._copied: list = []               # per slot: its last copy

    def _fit(self, frames: np.ndarray) -> None:
        """Slots for frames of this shape and dtype."""
        if self._host and (self._host[0].shape[1:] == frames.shape[1:]
                           and self._host[0].dtype == frames.dtype):
            return
        for ev in self._copied:
            ev.synchronize()
        per = max(1, STAGE_SLOT_BYTES // max(1, frames[0].nbytes))
        dtype = torch.from_numpy(np.empty(0, frames.dtype)).dtype
        cuda = self.device.type == "cuda"
        self.slots = [torch.empty((per, *frames.shape[1:]), dtype=dtype,
                                  pin_memory=cuda) for _ in range(2)]
        self._host = [slot.numpy() for slot in self.slots]
        self._copied = [torch.cuda.Event() for _ in self.slots] if cuda else []

    def stage(self, sel: FrameSelection,
              sizes: list[tuple[int, int]]) -> tuple[list[torch.Tensor], int]:
        """The selected frames → (one equalized work batch per (w, h) of
        `sizes`, [m, h, w] uint8 on the device with m the next power of
        two, n_real)."""
        frames, index = sel
        n = len(index)
        m = 1 << (n - 1).bit_length() if n else 0
        if not n:
            return [torch.empty((0, h, w), dtype=torch.uint8,
                                device=self.device) for w, h in sizes], 0
        with trace("vca.filter.upload"):
            self._fit(frames)
            per = len(self.slots[0])
            chunks = range(0, n, per)
            batch = torch.empty((n, *frames.shape[1:]),
                                dtype=self.slots[0].dtype, device=self.device)
            for c, lo in enumerate(chunks):
                rows = index[lo:lo + per]
                s, k = c % 2, len(rows)
                if self._copied:
                    self._copied[s].synchronize()
                # numpy's copy, on this thread: torch's parallel copy
                # stalled for up to 34 ms on an 8-core H100 host
                host = self._host[s]
                for j, i in enumerate(rows):
                    host[j] = frames[i]
                batch[lo:lo + k].copy_(self.slots[s][:k], non_blocking=True)
                if self._copied:
                    self._copied[s].record(
                        torch.cuda.current_stream(self.device))
            count("vca.filter.staged_frames", n)
            count("vca.filter.upload_chunks", len(chunks))
        works = []
        for w, h in sizes:
            work = torch.empty((m, h, w), dtype=torch.uint8,
                               device=self.device)
            work[:n] = resize_linear_exact(batch, (w, h))
            work[n:] = work[:1]
            works.append(equalize_hist(work))
        return works, n
