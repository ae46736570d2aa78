"""Where the time goes in the PyTorch port's learned face detectors
(``QuantizedCnnFaceDetector`` and ``CnnFaceDetector``) on a CUDA GPU.

    python3 tools/profile_torch_cnn.py        # one GPU; B=64 720p

For each detector, on warm B=64 batches of synthetic 1280x720 frames, it
prints, each line tagged with the card's name and power limit:

* the host side of ``process()``, stage by stage on the host clock (the
  device synchronized around each stage): the GOP-masked frame copy, the
  H2D upload from pageable memory, the device path, ``detect_boxes`` (all
  of these plus the D2H of the boxes and the host un-letterboxing), the
  per-frame track update, and the whole ``process()`` call;
* the device path's stages (letterbox, forward, decode, NMS) in device ms
  from CUDA events and host ms, and for the int8 forward the share of the
  7 quantizer calls;
* the profiler's device busy share and device ops per batch over the
  device path, and the ops with the most device time.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nubomedia_vca_tpu_torch.models import (  # noqa: E402
    CnnFaceDetector, QuantizedCnnFaceDetector)
from nubomedia_vca_tpu_torch.models.base import gated_gop_mask  # noqa: E402
from nubomedia_vca_tpu_torch.models.cnn import decode, nms  # noqa: E402
from nubomedia_vca_tpu_torch.ops.cuda.quant_cuda import (  # noqa: E402
    quantize_int8)
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

B, FRAME, REPS = 64, (1280, 720), 10


def device_timed(fn, reps=REPS):
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


def host_timed(fn, reps=REPS):
    """Host ms per call of fn, the device synchronized around each call."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total * 1000.0 / reps


def profile(det, frames, gpu: str) -> None:
    name = type(det).__name__
    dev = det.device
    mask = gated_gop_mask(det.gop, det.gate, len(frames), None)
    sub = frames[mask]
    gray = torch.from_numpy(sub).to(dev)
    _, _, valid = det.detect_device(gray)
    host_rows = [
        ("GOP-masked frame copy", lambda: frames[mask]),
        ("H2D upload (pageable)", lambda: torch.from_numpy(sub).to(dev)),
        ("device path", lambda: det.detect_device(gray)),
        ("detect_boxes (upload, device path, D2H, un-letterbox)",
         lambda: det.detect_boxes(sub)),
        ("whole process()", lambda: det.process(frames)),
    ]
    for what, fn in host_rows:
        print(f"{name} host: {what} {host_timed(fn):.4f} ms per B={B} 720p "
              f"batch [{gpu}]")
    dets = det.detect_boxes(sub)
    tracks = det.tracks[0]
    t0 = time.perf_counter()
    for d in dets:
        tracks.update(d, 40)
    print(f"{name} host: track update {(time.perf_counter() - t0) * 1e3:.4f}"
          f" ms per B={B} batch ({sum(len(d) for d in dets)} boxes) [{gpu}]")

    canvas = det.letterbox(gray)
    pred = det.model(canvas)
    dec = decode(pred, det.threshold)
    rows = [("letterbox", lambda: det.letterbox(gray)),
            ("forward", lambda: det.model(canvas)),
            ("decode", lambda: decode(pred, det.threshold)),
            ("NMS", lambda: nms(*dec, det.NMS_IOU)),
            ("whole device path", lambda: det.detect_device(gray))]
    if isinstance(det, QuantizedCnnFaceDetector):
        taps = []
        det.model(canvas, taps)
        xs = [x for x, _, _ in taps]
        rows.insert(2, ("of it the 7 quantizer calls",
                        lambda: [quantize_int8(x) for x in xs]))
    for what, fn in rows:
        d_ms, h_ms = device_timed(fn)
        print(f"{name} device: {what} {d_ms:.4f} ms (host {h_ms:.4f} ms) per "
              f"B={B} 720p batch [{gpu}]")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 5
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            det.detect_device(gray)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"{name} profile: {len(kernels) / n:.0f} device ops per batch, "
          f"device busy {busy_us / n / 1000.0:.4f} ms of "
          f"{wall_us / n / 1000.0:.4f} ms wall per batch "
          f"({100.0 * busy_us / wall_us:.1f}% busy) [{gpu}]")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))
    print(f"{name}: {int(valid.sum())} boxes kept in the profiled batch")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cnn: needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    frames = np.ascontiguousarray(face_clip(B, *FRAME, seed=11))
    for cls in (QuantizedCnnFaceDetector, CnnFaceDetector):
        profile(cls(FRAME, device=torch.device("cuda", 0)), frames, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
