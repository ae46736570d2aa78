"""Where the time goes in the PyTorch port's part chain on a CUDA GPU.

    python3 tools/profile_torch_parts.py        # one GPU; B=64 720p

For each part detector (nose, mouth, eyes) at 1280x720, on a warm B=64
batch of synthetic frames already on the card, it prints, each line tagged
with the card's name and power limit:

* per stage: device ms from CUDA events and host ms (the time the Python
  thread spends issuing the stage) — where host ms exceeds device ms the
  stage is launch-bound. Stages: the face and part images (resize +
  equalize), the face pass (detection + grouping), and per part engine the
  dense phase of each level route (pyramid kernel; resize + the tilted
  kernels), for a tilted engine its table pass
  (integral kernel + tilted-table kernel) and its evaluation kernel alone,
  the survivor stages of all levels, and the candidate compaction;
* the whole device pass's ms per batch, and the profiler's device busy
  share and device ops per batch;
* the ops with the most device time.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nubomedia_vca_tpu_torch.models import (  # noqa: E402
    EyeDetector, MouthDetector, NoseDetector)
from nubomedia_vca_tpu_torch.ops.cuda.dense_cuda import (  # noqa: E402
    pyramid_dense_phase)
from nubomedia_vca_tpu_torch.ops.cuda.dense_level_cuda import (  # noqa: E402
    _tilted_eval, tilted_table)
from nubomedia_vca_tpu_torch.ops.cuda.integral_cuda import (  # noqa: E402
    integral_tables)
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist  # noqa: E402
from nubomedia_vca_tpu_torch.ops.resize import (  # noqa: E402
    resize_linear_exact)
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

B, FRAME, REPS = 64, (1280, 720), 5


def timed(fn, reps=REPS):
    """(device ms, host ms) per call of fn, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1000.0 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def engine_stages(name, eng, work):
    """(stage name, fn) rows of one engine on its work images."""
    dense = {}
    if eng._plan is not None:
        for li, (img, vnf, alive) in zip(eng._pyramid_lis,
                                         pyramid_dense_phase(work, eng._plan)):
            dense[li] = (work if img is None else img, vnf, alive)
    for li in range(len(eng.levels)):
        if li not in dense:
            dense[li] = eng._dense_level(work, li)
    rows = []
    if eng._plan is not None:
        rows.append((f"{name} dense: pyramid kernel "
                     f"({len(eng._pyramid_lis)} levels)",
                     lambda: pyramid_dense_phase(work, eng._plan)))
    tilted = [li for li, r in enumerate(eng.routes) if r == "tilted"]
    if tilted:
        rows.append((f"{name} dense: tilted ({len(tilted)} levels)",
                     lambda: [eng._dense_level(work, li) for li in tilted]))
        imgs = {li: resize_linear_exact(work, (l.sw, l.sh))
                for li in tilted for l in [eng.levels[li]]}
        tables = {li: (ii, sq, dense[li][0][1]) for li in tilted
                  for ii, sq in [integral_tables(imgs[li])]}
        rows.append((f"{name} dense: tilted table pass, integral kernel + "
                     f"tilted table ({len(tilted)} levels)",
                     lambda: [tilted_table(integral_tables(imgs[li])[0])
                              for li in tilted]))
        rows.append((f"{name} dense: tilted evaluation kernel "
                     f"({len(tilted)} levels)",
                     lambda: [_tilted_eval(*tables[li], eng._level_plans[li])
                              for li in tilted]))
    rows.append((f"{name} survivors ({len(eng.levels)} levels)",
                 lambda: [eng._level_post(li, src, vnf, alive.bool())
                          for li, (src, vnf, alive) in dense.items()]))
    raw = eng._detect_impl(work)
    rows.append((f"{name} compact_raw", lambda: eng.compact_raw(raw)))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_parts: needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    frames = face_clip(B, *FRAME, seed=11)
    gray = torch.from_numpy(frames).to(dev)
    for det_cls in (NoseDetector, MouthDetector, EyeDetector):
        det = det_cls(FRAME, device=dev)
        label = det_cls.__name__

        def images():
            return (equalize_hist(resize_linear_exact(
                        gray, (det.face_w, det.face_h))),
                    equalize_hist(resize_linear_exact(
                        gray, (det.part_w, det.part_h))))

        face_img, part_img = images()
        fe = det.face_engine
        rows = [("resize+equalize (face and part images)", images),
                ("face pass (detect + group)", lambda: fe.group_device(
                    fe.detect_raw(face_img), det.FACE_MIN_NEIGHBORS))]
        for name, eng in det.part_engines.items():
            rows += engine_stages(name, eng, part_img)

        def device_pass():
            f, p = images()
            fe.group_device(fe.detect_raw(f), det.FACE_MIN_NEIGHBORS)
            return [eng.compact_raw(eng.detect_raw(p))
                    for eng in det.part_engines.values()]

        rows.append(("whole device pass", device_pass))
        for stage, fn in rows:
            d_ms, h_ms = timed(fn)
            print(f"{label} stage {stage}: device {d_ms:.4f} ms, host "
                  f"{h_ms:.4f} ms per B={B} 720p batch [{gpu}]")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                device_pass()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        print(f"{label} profile: {len(kernels) / REPS:.0f} device ops per "
              f"batch, device busy {busy_us / REPS / 1000.0:.4f} ms of "
              f"{wall_us / REPS / 1000.0:.4f} ms wall per batch "
              f"({100.0 * busy_us / wall_us:.1f}% busy), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{gpu}]")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=8, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
