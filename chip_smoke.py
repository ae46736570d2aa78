#!/usr/bin/env python3
"""Drive the PyTorch port's face-detection main path once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each printing its findings, any failure ending the run non-zero:

1. device check: CUDA present; card name and power limit; torch/CUDA;
2. build: compile ``csrc/pyramid_dense.cu`` with nvcc (ptxas report);
3. kernel vs plain version: on B=64 synthetic 1280x720 (and 640x480)
   frames resized and equalized on the card, every level image, ``vnf`` and
   ``alive`` of the kernel must equal ``pyramid_dense_phase_reference`` on
   the same CUDA tensors exactly;
4. main path: ``FaceDetector((1280, 720), device="cuda").process`` over
   consecutive batches of one stream; the kernel must launch once per
   batch, at least one face must be tracked, and the tracked faces (ids and
   rects) must equal the same port run on the CPU frame by frame; the raw
   candidates of the CUDA engine must equal the CPU engine's;
5. times: kernel and plain version ms per B=64 720p batch (CUDA events),
   the on-device detection path's ms per batch, and ``process()`` frames/s.

The last lines are the kernel summary as JSON, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and
``{"ok": true, "device": {...}}``. The script imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nubomedia_vca_tpu_torch.cascade.engine import get_engine  # noqa: E402
from nubomedia_vca_tpu_torch.models.face import (  # noqa: E402
    DEFAULT_FACE_CASCADE, FaceDetector)
from nubomedia_vca_tpu_torch.ops.cuda import _build, dense_cuda  # noqa: E402
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist  # noqa: E402
from nubomedia_vca_tpu_torch.ops.resize import (  # noqa: E402
    resize_linear_exact)
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

KERNEL_SOURCE = "nubomedia_vca_tpu_torch/csrc/pyramid_dense.cu"
KERNEL_REPLACES = "nubomedia_vca_tpu/ops/pallas/dense_pallas.py:371"
FRAME = (1280, 720)
BATCH = 64


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, n: int) -> float:
    """Mean ms per call of `fn` over n calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def work_images(frames: np.ndarray, engine, dev) -> torch.Tensor:
    gray = torch.from_numpy(frames).to(dev)
    return equalize_hist(resize_linear_exact(
        gray, (engine.image_w, engine.image_h)))


def compare_kernel(work: torch.Tensor, plan) -> tuple[float, int]:
    """Kernel vs plain version on the same CUDA tensors → (max |vnf| error,
    alive windows). Raises on any difference."""
    got = dense_cuda.pyramid_dense_phase(work, plan)
    want = dense_cuda.pyramid_dense_phase_reference(work, plan)
    torch.cuda.synchronize()
    err, n_alive = 0.0, 0
    for li, ((gi, gv, ga), (wi, wv, wa)) in enumerate(zip(got, want)):
        if (gi is None) != (wi is None) or (
                gi is not None and not torch.equal(gi, wi)):
            raise AssertionError(f"level {li}: level image differs")
        err = max(err, float((gv - wv).abs().max()))
        if not torch.equal(gv, wv):
            raise AssertionError(f"level {li}: vnf differs (max {err})")
        if not torch.equal(ga, wa):
            n = int((ga != wa).sum())
            raise AssertionError(f"level {li}: alive differs in {n} windows")
        n_alive += int(ga.sum())
    return err, n_alive


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)

    phase("1 device")
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()} name {torch.cuda.get_device_name(0)}")

    phase("2 build")
    path, log, seconds = _build.build_library("pyramid_dense")
    print(f"build: {path.name} in {seconds:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    phase("3 kernel vs plain version")
    rng_frames = {}
    max_err = 0.0
    for size in (FRAME, (640, 480)):
        eng = get_engine(DEFAULT_FACE_CASCADE,
                         (160, round(size[1] * 160 / size[0])), 1.25,
                         device=dev)
        frames = face_clip(BATCH, *size, seed=11)
        rng_frames[size] = frames
        work = work_images(frames, eng, dev)
        err, n_alive = compare_kernel(work, eng._plan)
        max_err = max(max_err, err)
        noise = torch.from_numpy(np.random.RandomState(5).randint(
            0, 256, work.shape, np.uint8)).to(dev)
        err2, n_alive2 = compare_kernel(noise, eng._plan)
        max_err = max(max_err, err2)
        print(f"{size[0]}x{size[1]} -> work {eng.image_w}x{eng.image_h}, "
              f"{len(eng.levels)} levels, B={BATCH}: kernel == plain "
              f"(level images, vnf, alive); alive windows {n_alive} "
              f"(faces) {n_alive2} (noise); smem {eng._plan.smem_bytes} B")

    phase("4 main path")
    clip = face_clip(4 * 16, *FRAME, seed=0)
    batches = np.split(clip, 4)
    fd = FaceDetector(FRAME, device=dev)
    dense_cuda.pyramid_dense_phase.launches = 0
    gpu_faces = []
    for b in batches:
        gpu_faces += fd.process(b)
    torch.cuda.synchronize()
    launches = dense_cuda.pyramid_dense_phase.launches
    print(f"process: {len(batches)} batches of {len(batches[0])} frames, "
          f"kernel launches {launches}")
    if launches != len(batches):
        raise AssertionError(
            f"expected one kernel launch per batch, got {launches}")
    n_tracked = sum(len(f) for f in gpu_faces)
    ids = sorted({f.id for fs in gpu_faces for f in fs})
    print(f"tracked faces: {n_tracked} over {len(gpu_faces)} frames, ids {ids}")
    if n_tracked < 1:
        raise AssertionError("no face tracked on the synthetic clip")
    fd_cpu = FaceDetector(FRAME, device="cpu")
    cpu_faces = []
    for b in batches:
        cpu_faces += fd_cpu.process(b)

    def as_tuples(faces):
        return [[(f.id, f.rect()) for f in fs] for fs in faces]

    if as_tuples(gpu_faces) != as_tuples(cpu_faces):
        raise AssertionError("CUDA tracked faces differ from the CPU run")
    print("tracked faces: CUDA == CPU, frame by frame (ids and rects)")
    eng_gpu = fd.engine
    eng_cpu = fd_cpu.engine
    work_cpu = work_images(rng_frames[FRAME], eng_cpu, "cpu")
    cand_gpu = eng_gpu.candidates(work_cpu.to(dev))
    cand_cpu = eng_cpu.candidates(work_cpu)
    n_cand = 0
    for a, b in zip(cand_gpu, cand_cpu):
        if not np.array_equal(np.sort(a, axis=0), np.sort(b, axis=0)):
            raise AssertionError("CUDA raw candidates differ from the CPU")
        n_cand += len(a)
    if n_cand == 0:
        raise AssertionError("no raw candidates on the synthetic frames")
    print(f"raw candidates: CUDA == CPU on B={BATCH} ({n_cand} windows)")

    phase("5 times")
    work = work_images(rng_frames[FRAME], eng_gpu, dev)
    plan = eng_gpu._plan
    kernel_ms, plain_ms = [], []
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            kernel_ms.append(cuda_ms(
                lambda: dense_cuda.pyramid_dense_phase(work, plan), 50))
        else:
            plain_ms.append(cuda_ms(
                lambda: dense_cuda.pyramid_dense_phase_reference(work, plan),
                10))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    print(f"time: pyramid dense kernel {k_ms:.4f} ms/batch "
          f"(runs {['%.4f' % v for v in kernel_ms]}), plain version "
          f"{p_ms:.4f} ms/batch (runs {['%.4f' % v for v in plain_ms]}); "
          f"B={BATCH} 720p work 160x90 [{gpu}]")
    gray = torch.from_numpy(rng_frames[FRAME]).to(dev)
    dev_ms = cuda_ms(lambda: eng_gpu.detect_grouped(equalize_hist(
        resize_linear_exact(gray, (eng_gpu.image_w, eng_gpu.image_h)))), 20)
    print(f"time: device path (resize, equalize, cascade, grouping on "
          f"device-resident frames) {dev_ms:.4f} ms/batch, "
          f"{BATCH * 1000.0 / dev_ms:.1f} frames/s; B={BATCH} 720p [{gpu}]")
    fd_t = FaceDetector(FRAME, device=dev)
    fd_t.process(rng_frames[FRAME])
    torch.cuda.synchronize()
    n_rep = 10
    t0 = time.perf_counter()
    for _ in range(n_rep):
        fd_t.process(rng_frames[FRAME])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"time: FaceDetector.process {n_rep * BATCH / secs:.1f} frames/s "
          f"({secs * 1000.0 / n_rep:.3f} ms per {BATCH}-frame 720p host "
          f"batch, host frames in, tracked faces out) [{gpu}]")

    print(json.dumps({"kernels": [{
        "name": "pyramid_dense_phase", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
