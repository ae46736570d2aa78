"""Where the time goes in the PyTorch port's face path on a CUDA GPU.

    python3 tools/profile_torch_face.py        # one GPU; B=64 720p

On a warm B=64 batch of synthetic 1280x720 frames already on the card it
prints, each line tagged with the card's name and power limit:

* per stage (resize+equalize, pyramid dense kernel, per-level survivor
  stages, grouping): device ms from CUDA events and host ms (the time the
  Python thread spends issuing the stage, synchronized before and after) —
  where host ms exceeds device ms the stage is launch-bound;
* the whole device path's ms per batch, and the profiler's device busy
  share (kernel time / wall time of the profiled window) and kernel
  launches per batch;
* the host's issue floor: the ms the Python thread takes to issue one
  batch onto an idle device (synchronized before each batch, so no full
  launch queue pushes back), and the host-device syncs per batch. Below the
  device ms the path is device-bound; at or above it, launch-bound;
* the ops with the most device time.
"""

from __future__ import annotations

import os
import subprocess
import sys
import statistics
import time
import warnings

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nubomedia_vca_tpu_torch.cascade.engine import get_engine  # noqa: E402
from nubomedia_vca_tpu_torch.models.face import (  # noqa: E402
    DEFAULT_FACE_CASCADE)
from nubomedia_vca_tpu_torch.ops.cuda.dense_cuda import (  # noqa: E402
    pyramid_dense_phase)
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist  # noqa: E402
from nubomedia_vca_tpu_torch.ops.resize import (  # noqa: E402
    resize_linear_exact)
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

B, FRAME, REPS = 64, (1280, 720), 20


def timed(fn, reps=REPS):
    """(device ms, host ms) per call of fn, warm."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    host = (time.perf_counter() - t0) * 1000.0 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host, out


def issue_floor(fn, reps=REPS):
    """(median host ms to issue one call of fn onto an idle device, syncs
    per call). The device is synchronized before each call, so the launch
    queue is empty and never pushes back on the host."""
    fn()
    times = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1000.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
    torch.cuda.synchronize()
    return statistics.median(times), syncs / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_face: needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    eng = get_engine(DEFAULT_FACE_CASCADE, (160, 90), 1.25, device=dev)
    gray = torch.from_numpy(face_clip(B, *FRAME, seed=11)).to(dev)

    def prep():
        return equalize_hist(resize_linear_exact(gray, (160, 90)))

    work = prep()
    levels = pyramid_dense_phase(work, eng._plan)
    raw = eng._detect_impl(work)
    rows = [("resize+equalize", prep),
            ("pyramid dense kernel", lambda: pyramid_dense_phase(
                work, eng._plan))]
    for li, (img_l, vnf, alive) in enumerate(levels):
        img = work if img_l is None else img_l
        rows.append((f"level {li} survivors ({eng.levels[li].sw}x"
                     f"{eng.levels[li].sh})",
                     lambda li=li, img=img, vnf=vnf, alive=alive:
                     eng._level_post(li, img, vnf, alive.bool())))
    rows.append(("grouping", lambda: eng.group_device(raw, 3)))
    rows.append(("whole device path", lambda: eng.detect_grouped(prep(), 3)))
    for name, fn in rows:
        d_ms, h_ms, _ = timed(fn)
        print(f"stage {name}: device {d_ms:.4f} ms, host {h_ms:.4f} ms "
              f"per B={B} 720p batch [{gpu}]")
    floor_ms, syncs = issue_floor(lambda: eng.detect_grouped(prep(), 3))
    print(f"issue floor: host {floor_ms:.4f} ms to issue one B={B} 720p "
          f"batch onto an idle device (median of {REPS}), {syncs:g} "
          f"host-device syncs per batch [{gpu}]")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 5
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.detect_grouped(prep(), 3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"profile: {len(kernels) / n:.0f} device ops per batch, device "
          f"busy {busy_us / n / 1000.0:.4f} ms of {wall_us / n / 1000.0:.4f} "
          f"ms wall per batch ({100.0 * busy_us / wall_us:.1f}% busy) "
          f"[{gpu}]")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
