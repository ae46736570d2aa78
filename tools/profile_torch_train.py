"""Where the time goes in the PyTorch port's training step and its
distillation teacher on a CUDA GPU.

    python3 tools/profile_torch_train.py      # one GPU; B=32 at 320x240

At the shipped width (convs 1→16→32→64→128, context conv, head 128→256→5)
on a warm B=32 batch of ``utils/synth.face_clip`` frames at 320x240,
labelled by the teacher (``distill.make_teacher``), it prints, each line
tagged with the card's name and power limit:

* device ms (CUDA events) and host ms per call of the step's stages: the
  forward alone, forward + loss + backward, AdamW's step with the
  schedule's, the whole ``cnn.train_step``; the targets
  (``cnn.boxes_to_targets``), the teacher's device path
  (``detect_grouped``) and ``label_batch`` from host frames;
* the memory held by the weights and AdamW's state, and a step's peak;
* the profiler's device busy share and device ops per step and per
  labelled batch, and the ops with the most device time.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nubomedia_vca_tpu_torch.models import cnn, distill  # noqa: E402
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

B, REPS = 32, 20


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


def profiled(fn, n: int, what: str, gpu: str) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"profile: {what}: {len(kernels) / n:.0f} device ops per call, "
          f"device busy {busy_us / n / 1000.0:.4f} ms of "
          f"{wall_us / n / 1000.0:.4f} ms wall per call "
          f"({100.0 * busy_us / wall_us:.1f}% busy) [{gpu}]")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    frames = face_clip(B, distill.W, distill.H, seed=5)
    teacher = distill.make_teacher(dev)
    labels = [torch.from_numpy(a).to(dev)
              for a in distill.label_batch(teacher, frames)]
    gray = torch.from_numpy(frames).to(dev)
    obj_t, reg_t = cnn.boxes_to_targets(*labels, distill.H, distill.W)
    base = torch.cuda.memory_allocated(dev)
    model = cnn.CnnNet(cnn.init_params(torch.Generator().manual_seed(0),
                                       ctx=True)).to(dev)
    opt, sched = cnn.make_optimizer(model.parameters(), 3e-4, steps=1500)
    for _ in range(3):
        cnn.train_step(model, opt, sched, gray, obj_t, reg_t)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    cnn.train_step(model, opt, sched, gray, obj_t, reg_t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    print(f"memory: weights and AdamW state {held / 2**20:.2f} MiB; a step's "
          f"peak above what it starts with {peak / 2**20:.1f} MiB at B={B} "
          f"{distill.W}x{distill.H} [{gpu}]")

    def fwd():
        with torch.no_grad():
            model(gray)

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        cnn.loss_fn(model, gray, obj_t, reg_t)[0].backward()

    def update():
        opt.step()
        sched.step()

    fwd_bwd()
    rows = [("forward alone", fwd),
            ("forward, loss and backward", fwd_bwd),
            ("AdamW step and schedule", update),
            ("whole train_step",
             lambda: cnn.train_step(model, opt, sched, gray, obj_t, reg_t)),
            ("targets (boxes_to_targets)",
             lambda: cnn.boxes_to_targets(*labels, distill.H, distill.W)),
            ("teacher device path (detect_grouped)",
             lambda: teacher.detect_grouped(gray, 3))]
    for what, fn in rows:
        d_ms, h_ms = device_timed(fn, 5 if "teacher" in what else REPS)
        print(f"stage: {what} {d_ms:.4f} ms (host {h_ms:.4f} ms) per B={B} "
              f"{distill.W}x{distill.H} batch [{gpu}]")
    t0 = time.perf_counter()
    for _ in range(3):
        distill.label_batch(teacher, frames)
    print(f"stage: label_batch from host frames "
          f"{(time.perf_counter() - t0) * 1000.0 / 3:.4f} ms per batch "
          f"[{gpu}]")
    profiled(lambda: cnn.train_step(model, opt, sched, gray, obj_t, reg_t),
             5, "train step", gpu)
    profiled(lambda: teacher.detect_grouped(gray, 3), 2,
             "teacher, one labelled batch", gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
