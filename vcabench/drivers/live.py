"""Live traffic: 720p webcam sessions through the media plane, as a
Kurento-style deployment runs them: one ``api/objects.MediaPipeline``
a camera with one ``NuboFaceDetector`` at the reference's defaults,
``listen(port=0, channels=3, output=1, downscale=1)``, BGR in and the
annotated BGR frame back on the same connection.

The load comes from ``live_client.py``, a process of its own that sends
each camera's frames on a fixed schedule (an open loop) and stamps each
annotated frame's arrival. A frame's latency runs from its due time to
its arrival; a frame that never comes back counts as failed.

The check replays each camera's frames, warm-up included, through the
plain reference (BGR to luma, the face filter, the tracks, the rectangles
drawn on the BGR frame) and compares the digests of a sample of frames
drawn from the seed.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ..reference import cascade as C
from ..reference import filters as ref
from . import live_client

RENDER_COLOR = (255, 128, 0)     # BaseFace::colors[1], BGR
RENDER_THICKNESS = 2


def draw_rects(bgr: np.ndarray, rects) -> np.ndarray:
    """A copy of `bgr` [H, W, 3] with each rect's border drawn: every
    pixel within the thickness of the rect's edges, inside or outside."""
    out = bgr.copy()
    H, W = out.shape[:2]
    t = RENDER_THICKNESS
    for x, y, w, h in rects:
        y0, y1 = max(y - t, 0), min(y + h + t + 1, H)
        x0, x1 = max(x - t, 0), min(x + w + t + 1, W)
        if y0 >= y1 or x0 >= x1:
            continue
        ys = np.arange(y0, y1)[:, None]
        xs = np.arange(x0, x1)[None, :]
        ring = ~((xs >= x + t) & (xs <= x + w - t)
                 & (ys >= y + t) & (ys <= y + h - t))
        out[y0:y1, x0:x1][ring] = RENDER_COLOR
    return out


class Steps:
    """A benchmark-side wrapper around ``MediaRunner._step``: steps,
    frames stepped and host seconds inside, while ``on``."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.steps = self.frames = 0
        self.seconds = 0.0

    def install(self):
        """Wrap ``MediaRunner._step``; ``remove`` puts it back."""
        from nubomedia_vca_tpu_torch.api import media_loop
        self.real = real = media_loop.MediaRunner._step
        steps = self

        def _step(runner, frames, *a, **kw):
            t = time.perf_counter()
            try:
                return real(runner, frames, *a, **kw)
            finally:
                if steps.on:
                    with steps.lock:
                        steps.steps += 1
                        steps.frames += len(frames)
                        steps.seconds += time.perf_counter() - t

        media_loop.MediaRunner._step = _step

    def remove(self):
        from nubomedia_vca_tpu_torch.api import media_loop
        media_loop.MediaRunner._step = self.real


def serve(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
          device: torch.device, steps: Steps | None = None) -> dict:
    """Set up the cameras and the load generator, run the window → the
    client's record and the serving counters at the window's start
    (stats0), at its last due time (stats1) and once every frame is back
    or the wait is over (stats2)."""
    from nubomedia_vca_tpu_torch.api.objects import (MediaPipeline,
                                                     NuboFaceDetector)
    n = mix["cameras"]
    pipes, ports = [], []
    for _ in range(n):
        pipe = MediaPipeline(tuple(cfg["frame"]), device)
        NuboFaceDetector(pipe)
        ports.append(pipe.listen(0, 3, 1, 1))
        pipes.append(pipe)
    spec = {"mix": mix, "frame": cfg["frame"], "seed": seed,
            "seconds": seconds, "ports": ports}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    client = subprocess.Popen(
        [sys.executable, "-m", "vcabench.drivers.live_client",
         json.dumps(spec)], cwd=root, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True)
    prof = None
    try:
        for want in ("ready", "warm"):
            line = client.stdout.readline().strip()
            if line != want:
                raise RuntimeError(f"live client said {line!r}, not {want}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        stats0 = [p.getStats() for p in pipes]
        if trace:
            # the device's activity over the whole window; the profiler
            # stops, and its trace is read, only once every frame is back,
            # so that reading it takes no time from the serving threads
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(activities=[
                act.CUDA if device.type == "cuda" else act.CPU])
            prof.__enter__()
        if steps is not None:
            steps.on = True
        client.stdin.write("go\n")
        client.stdin.flush()
        t0 = float(client.stdout.readline().split()[1])
        # the counters at the last frame's due time
        time.sleep(max(0.0, t0 + seconds - 1.0 / mix["fps"]
                       - time.monotonic()))
        stats1 = [p.getStats() for p in pipes]
        record = json.loads(client.stdout.readline())
        if steps is not None:
            steps.on = False
        stats2 = [p.getStats() for p in pipes]
        if prof is not None:
            prof.__exit__(None, None, None)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    finally:
        client.stdin.close()
        client.wait(timeout=60)
        for p in pipes:
            p.release()
    return dict(t0=t0, record=record, stats0=stats0, stats1=stats1,
                stats2=stats2, prof=prof, memory_peak_bytes=peak)


def latencies(record: dict) -> tuple[list[float], int, float]:
    """(latency ms of every window frame, the last arrival's time, frames
    back): a frame that never came back counts from its due time to the
    end of the wait."""
    due = record["due"]
    out, last, back = [], record["t0"], 0
    end = max([due[-1]] + [a for c in record["cameras"]
                           for a in c["arrivals"]])
    for cam in record["cameras"]:
        arr = cam["arrivals"]
        back += len(arr)
        for k, d in enumerate(due):
            out.append(((arr[k] if k < len(arr) else end) - d) * 1e3)
        if arr:
            last = max(last, arr[-1])
    return out, last, back


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (statistics.quantiles' exclusive method)."""
    return statistics.quantiles(values, n=100)[int(q) - 1]


def expected(cfg: dict, mix: dict, seed: int, record: dict,
             cascade_dir: str, device, prec=torch.float32) -> list[dict]:
    """Per camera, {frame k: digest of its annotated frame} of the
    reference in `prec`, for a sample of each camera's frames drawn from
    the seed (warm-up included); the tracks are replayed over every
    frame."""
    clips = live_client.bgr_clips(mix, cfg["frame"], seed)
    flt = ref.FaceFilter(cfg, cascade_dir, device, prec)
    rng = np.random.RandomState((seed + 7) % (2 ** 32))
    out = []
    for ci, cam in enumerate(record["cameras"]):
        clip = clips[ci]
        dets = flt.detect(C.gray_from_bgr(torch.from_numpy(clip)))
        total = cam["warm"] + len(record["due"])
        sample = set(rng.choice(total, min(mix["check_frames"], total),
                                replace=False).tolist())
        tracks, want = ref.Tracks(), {}
        for k in range(total):
            j = live_client.clip_index(k, len(clip))
            faces = tracks.update(dets[j], cfg["track_threshold"])
            if k in sample:
                want[k] = hashlib.blake2b(
                    draw_rects(clip[j], [f[:4] for f in faces]).tobytes(),
                    digest_size=16).hexdigest()
        out.append(want)
    return out


def compare(want: list[dict], got: list[list]) -> tuple[int, int]:
    """(frames compared, frames whose digest differs or never came)."""
    n = bad = 0
    for w, g in zip(want, got):
        for k, d in w.items():
            n += 1
            bad += k >= len(g) or g[k] != d
    return n, bad


def check(cfg: dict, mix: dict, seed: int, record: dict,
          cascade_dir: str, device) -> tuple[int, int]:
    """(frames compared, frames whose annotated frame differs from the
    reference's, or never came back)."""
    want = expected(cfg, mix, seed, record, cascade_dir, device)
    return compare(want, [c["digests"] for c in record["cameras"]])


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, cascade_dir: str) -> dict:
    steps = Steps()
    if trace:
        steps.install()
    try:
        s = serve(cfg, mix, seed, seconds, trace, device, steps)
    finally:
        if trace:
            steps.remove()
    lat, last, back = latencies(s["record"])
    attempted = len(s["record"]["due"]) * mix["cameras"]
    t = time.perf_counter()
    n, bad = check(cfg, mix, seed, s["record"], cascade_dir, device)
    print(f"live: {n} frames checked in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    late = [max(0.0, x - d) for c in s["record"]["cameras"]
            for x, d in zip(c["sends"], s["record"]["due"])]
    print(f"live: generator lateness ms max {max(late) * 1e3!r} mean "
          f"{statistics.fmean(late) * 1e3!r}", file=sys.stderr)
    print(f"live: frames dropped at the ingest "
          f"{sum(st['dropped'] for st in s['stats2'])}, on the way back "
          f"{sum(st['outDropped'] for st in s['stats2'])}", file=sys.stderr)
    return dict(
        t_start=s["t0"], attempted=attempted, failed=attempted - back,
        e2e={"frames_per_s": back / (last - s["t0"]),
             "latency_ms_p50": statistics.median(lat),
             "latency_ms_p95": percentile(lat, 95)},
        memory_peak_bytes=s["memory_peak_bytes"],
        checks={"frames_differing_pct": 100.0 * bad / max(n, 1),
                "frames_unanswered": attempted - back},
        checked_frames=n,
        layer=dict(prof=s["prof"], window_range=None,
                   steps=steps.steps, step_frames=steps.frames,
                   step_seconds=steps.seconds,
                   backlog=_pending_delta(s), cfg=cfg, device=device,
                   cascade_dir=cascade_dir))


def _pending_delta(s) -> int:
    return (sum(st["pending"] for st in s["stats1"])
            - sum(st["pending"] for st in s["stats0"]))
