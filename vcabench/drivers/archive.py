"""Archive traffic: recorded footage re-analysed through the filter loop
the CLI runs for a clip, ``FaceDetector.process`` or
``EyeDetector.process`` with ``stream=s``.

Each stream's clip is drawn once from the seed (``frozen/scenes.py``) and
handed over as host luma frames, the Y plane a decoder gives. A call takes
``batch`` consecutive frames of one stream; the streams are taken in
turn, and each stream's clip plays forward, then backward, so that its
motion stays continuous. The calls are made back to back (a closed loop:
recorded footage waits for nobody) until the window's seconds are over.

The check replays every call of every stream through the plain
reference (``reference/filters.py``) and compares each frame's result.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch

from ..frozen import scenes
from ..reference import filters as ref

WARM_STREAM = 1 << 20          # the warm-up's stream id, never measured


def _program(cfg: dict, device: torch.device):
    """The filter of `cfg`, built as the CLI builds it."""
    frame = tuple(cfg["frame"])
    if cfg["filter"] == "face":
        from nubomedia_vca_tpu_torch.models.face import (FaceDetector,
                                                         FaceDetectorConfig)
        return FaceDetector(frame, FaceDetectorConfig(
            width_to_process=cfg["width_to_process"],
            multi_scale_factor=cfg["multi_scale_factor"],
            process_x_every_4_frames=cfg["process_x_every_4_frames"],
            min_neighbors=cfg["min_neighbors"],
            euclidean_distance=cfg["euclidean_distance"],
            track_threshold=cfg["track_threshold"],
            area_threshold=cfg["area_threshold"]), device=device)
    if cfg["filter"] == "eye":
        from nubomedia_vca_tpu_torch.cascade.paths import PKG_ASSETS_DIR
        from nubomedia_vca_tpu_torch.models.eye import (EyeDetector,
                                                        EyeDetectorConfig)
        return EyeDetector(frame, EyeDetectorConfig(
            width_to_process=cfg["width_to_process"],
            face_width=cfg["face_width"],
            multi_scale_factor=cfg["multi_scale_factor"],
            process_x_every_4_frames=cfg["process_x_every_4_frames"],
            euclidean_distance=cfg["euclidean_distance"],
            max_fps_without_detection=cfg["max_fps_without_detection"],
            right_cascade_path=os.path.join(PKG_ASSETS_DIR,
                                            cfg["right_cascade"]),
            left_cascade_path=os.path.join(PKG_ASSETS_DIR,
                                           cfg["left_cascade"])),
            device=device)
    raise ValueError(f"no archive filter {cfg['filter']!r}")


def as_plain(cfg: dict, frame_out) -> object:
    """One frame's result → plain tuples, as the reference gives them."""
    if cfg["filter"] == "face":
        return [f if isinstance(f, tuple) else (f.x, f.y, f.w, f.h, f.id)
                for f in frame_out]
    return {k: [tuple(int(v) for v in b) for b in frame_out[k]]
            for k in ("eye_right", "eye_left")}


class Archive:
    """One run of the archive mix: set-up, window, check."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, cascade_dir: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = device
        self.cascade_dir = cascade_dir
        frame = tuple(cfg["frame"])
        clips, self.layout = scenes.clips(mix, frame, seed, device)
        # host luma frames, as a decoder hands the Y plane over
        self.pool = clips.cpu().numpy()
        del clips
        self.program = _program(cfg, device)
        self.batch = mix["batch"]
        if self.pool.shape[1] != self.batch:
            raise ValueError("a call takes one clip: batch == clip_frames")
        self.n_streams = self.pool.shape[0]
        self.calls: list[tuple[int, int]] = []     # (stream, direction)
        self.results: list = []                    # per call, or None

    def frames(self, stream: int, direction: int) -> np.ndarray:
        clip = self.pool[stream]
        return clip if direction == 0 else clip[::-1]

    def warm_up(self) -> None:
        """Every shape the window uses: one call shape (a whole clip)."""
        for _ in range(2):
            self.program.process(self.frames(0, 0), stream=WARM_STREAM)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, i: int, record=None) -> int:
        """The window's i-th call → frames answered."""
        s, k = i % self.n_streams, i // self.n_streams
        d = k % 2
        self.calls.append((s, d))
        try:
            if record is not None:
                with record("vcabench.process"):
                    out = self.program.process(self.frames(s, d), stream=s)
            else:
                out = self.program.process(self.frames(s, d), stream=s)
        except Exception:  # noqa: BLE001 — a failed call counts as failed
            traceback.print_exc(file=sys.stderr)
            out = None
        ok = out is not None and len(out) == self.batch
        self.results.append(out if ok else None)
        return self.batch if ok else 0

    def release(self) -> None:
        """Free the program's device state before the check."""
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference(self, prec=torch.float32):
        flt = (ref.FaceFilter if self.cfg["filter"] == "face"
               else ref.EyeFilter)
        return flt(self.cfg, self.cascade_dir, self.device, prec)

    def expected(self, flt) -> dict:
        """Reference results of every call, in call order: {call index:
        [per-frame result]}. Detections are made once per clip frame (the
        calls replay the clips), a clip at a time."""
        dets = {s: flt.detect(self.pool[s])
                for s in sorted({s for s, _ in self.calls})}
        out = {}
        for i, (s, d) in enumerate(self.calls):
            order = range(self.batch) if d == 0 else range(self.batch - 1,
                                                           -1, -1)
            if self.cfg["filter"] == "face":
                out[i] = flt.track(s, [dets[s][j] for j in order])
            else:
                out[i] = [flt.frame_result(s, dets[s][j]) for j in order]
        return out

    def compare(self, expected: dict, got: dict) -> tuple[int, int]:
        """(frames compared, frames that differ); a missing call counts
        every frame as differing."""
        n = bad = 0
        for i, want in expected.items():
            have = got.get(i)
            for j, w in enumerate(want):
                n += 1
                if have is None or as_plain(self.cfg, have[j]) != w:
                    bad += 1
        return n, bad

    def check(self) -> tuple[int, int]:
        want = self.expected(self.reference())
        got = {i: r for i, r in enumerate(self.results) if i in want}
        return self.compare(want, got)


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, cascade_dir: str) -> dict:
    """One run → the numbers ``run.py`` reports."""
    a = Archive(cfg, mix, seed, device, cascade_dir)
    from nubomedia_vca_tpu_torch.cascade import engine as eng_mod
    post = eng_mod.CascadeEngine._level_post
    if trace:
        def level_post(self, *args, **kw):
            with torch.profiler.record_function("vcabench.survivor"):
                return post(self, *args, **kw)

        eng_mod.CascadeEngine._level_post = level_post
    try:
        return _window(a, mix, seconds, trace, device, cfg, cascade_dir)
    finally:
        eng_mod.CascadeEngine._level_post = post


def _window(a: Archive, mix: dict, seconds: float, trace: bool,
            device: torch.device, cfg: dict, cascade_dir: str) -> dict:
    a.warm_up()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof, n_traced = None, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    done = i = 0
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        try:
            n_traced = mix["trace_calls"]
            for i in range(n_traced):
                done += a.call(i, torch.profiler.record_function)
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.__exit__(None, None, None)
        i = n_traced
    while time.perf_counter() < deadline:
        done += a.call(i)
        i += 1
    t_end = time.perf_counter()
    attempted = len(a.calls) * a.batch
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    a.release()
    t = time.perf_counter()
    n, bad = a.check()
    print(f"archive: {n} frames checked in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    traced: dict[int, int] = {}
    for s, _ in a.calls[:n_traced]:
        traced[s] = traced.get(s, 0) + 1
    return dict(
        t_start=t_start, attempted=attempted, failed=attempted - done,
        e2e={"frames_per_s": done / (t_end - t_start)},
        memory_peak_bytes=peak,
        checks={"frames_differing_pct": 100.0 * bad / max(n, 1),
                "frames_unanswered": attempted - done},
        checked_frames=n,
        layer=dict(prof=prof, calls=n_traced, pool=a.pool,
                   traced_streams=traced, cfg=cfg, cascade_dir=cascade_dir,
                   device=device))
