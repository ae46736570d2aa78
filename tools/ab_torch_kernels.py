"""Time two versions of the port's pyramid, integral and tilted-evaluation
kernels against each other on one CUDA GPU, in turns.

    python3 tools/ab_torch_kernels.py --old-csrc DIR [--out FILE]

DIR holds an earlier version's ``pyramid_dense.cu``, ``integral_tables.cu``
and ``dense_level.cu`` with the headers they include, in the C interfaces
they had before the band layout (``pyramid_dense_launch`` with one block
per (level, frame), ``integral_tables_launch`` with one block per frame,
``tilted_eval_launch`` as now). The tool builds them with the port's nvcc
flags into ``build/ab_kernels/``, checks that old and new give the same
outputs, and times, per B=64 batch of synthetic 720p frames:

* the pyramid kernel on the face path's 7 levels (160x90) and on the
  nose's 20-level launch (320x180);
* the integral kernel over the right eye's 24 tilted levels, its 6
  largest, and the mouth's 23;
* the tilted evaluation kernel over the right eye's 24 levels, and the
  whole tilted dense phase (integral kernel, tilted-table kernel,
  evaluation) over its 18 smaller, all 24 and 6 largest levels;

each as old, new, new, old with CUDA events around 50 calls (mean ms per
call sequence, host issue included) and the host's time to issue them,
and each version's kernel time alone
from ``torch.profiler`` (device µs summed over the kernels of one call
sequence). Every line carries the card's ``nvidia-smi`` name and power
limit; FILE (default ``build/ab_kernels/ab_kernels.json``) gets the
numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nubomedia_vca_tpu_torch.models import (  # noqa: E402
    EyeDetector, FaceDetector, MouthDetector, NoseDetector)
from nubomedia_vca_tpu_torch.ops.cuda import (  # noqa: E402
    _build, dense_cuda, dense_level_cuda, integral_cuda)
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist  # noqa: E402
from nubomedia_vca_tpu_torch.ops.resize import (  # noqa: E402
    resize_linear_exact)
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

B, FRAME, N_CALLS = 64, (1280, 720), 50
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_LEVEL_FIELDS = 10     # the level record before the band layout


def build_old(src_dir: pathlib.Path, name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "ab_kernels" / f"lib{name}_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
           str(src_dir / f"{name}.cu")]
    proc = subprocess.run(cmd, check=True, capture_output=True, text=True)
    print_ptxas(f"old {name}", proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


def print_ptxas(what: str, log: str) -> None:
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas ({what}): {line.strip()}", flush=True)


def stream_args(dev):
    return dense_cuda.device_index(dev), torch.cuda.current_stream(
        dev).cuda_stream


class Old:
    """The earlier version's wrappers: its launchers, bound with their C
    interfaces, behind the same checks, allocations and output views as
    the current wrappers, so that both sides pay the same host work."""

    def __init__(self, src_dir: pathlib.Path):
        self.pyr = build_old(src_dir, "pyramid_dense")
        self.pyr.pyramid_dense_launch.argtypes = [
            I, P, P, I, I, I, P, I, P, *dense_cuda.CASCADE_ARGTYPES, I, P, P,
            P]
        self.integ = build_old(src_dir, "integral_tables")
        self.integ.integral_tables_launch.argtypes = [I, P, P, I, I, I, P, P]
        self.level = build_old(src_dir, "dense_level")
        self.level.tilted_eval_launch.argtypes = \
            dense_level_cuda._library().tilted_eval_launch.argtypes
        self._levels: dict = {}

    def pyramid(self, work, plan):
        dense_cuda._check_work(work, plan)
        plan.check_fits()
        dev = work.device
        key = (id(plan), dev)
        if key not in self._levels:
            self._levels[key] = torch.from_numpy(np.ascontiguousarray(
                plan._host["levels"][:, :OLD_LEVEL_FIELDS])).to(dev)
        t = plan.device_tables(dev)
        img = torch.empty(max(B * plan.img_unit, 1), dtype=torch.uint8,
                          device=dev)
        vnf = torch.empty(B * plan.map_unit, dtype=torch.float32, device=dev)
        alive = torch.empty(B * plan.map_unit, dtype=torch.uint8, device=dev)
        rc = self.pyr.pyramid_dense_launch(
            *stream_args(dev), work.data_ptr(), B, plan.image_h, plan.image_w,
            self._levels[key].data_ptr(), len(plan.levels),
            t["rtab"].data_ptr(), *plan.tables.launch_args(dev),
            plan.smem_bytes, img.data_ptr(), vnf.data_ptr(), alive.data_ptr())
        assert rc == 0, rc
        return dense_cuda.level_outputs(plan, B, img, vnf, alive)

    def integral(self, img):
        if img.dtype != torch.uint8 or img.ndim != 3:
            raise TypeError("image must be [B,H,W] uint8")
        if not img.is_contiguous():
            raise ValueError("image must be contiguous")
        Bi, H, W = img.shape
        ii = torch.empty((Bi, H + 1, W + 1), dtype=torch.int32,
                         device=img.device)
        sq = torch.empty_like(ii)
        rc = self.integ.integral_tables_launch(
            *stream_args(img.device), img.data_ptr(), Bi, H, W, ii.data_ptr(),
            sq.data_ptr())
        assert rc == 0, rc
        return ii, sq

    def tilted_eval(self, ii, sq, iit, plan):
        lib = dense_level_cuda._library
        dense_level_cuda._library = lambda: self.level
        try:
            return dense_level_cuda._tilted_eval(ii, sq, iit, plan)
        finally:
            dense_level_cuda._library = lib

    def tilted_phase(self, img, plan):
        """dense_level_tilted as it was: the old integral and evaluation
        kernels around the (unchanged) tilted-table kernel."""
        ii, sq = self.integral(img)
        iit = dense_level_cuda.tilted_table(ii)
        return (ii, iit, *self.tilted_eval(ii, sq, iit, plan))


def new_pyramid(work, plan):
    return dense_cuda.pyramid_dense_phase(work, plan)


def cuda_ms(fn, n=N_CALLS):
    """(device ms, host issue ms) per call of fn: CUDA events around n
    calls, and the host's time to issue them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, host


def kernel_us(fn, names):
    """Device µs of the kernels whose names contain one of `names`, summed
    over one call of fn (torch.profiler; mean over 5 calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            total += float(getattr(e, "device_time_total", 0.0)
                           or getattr(e, "cuda_time_total", 0.0))
    return total / 5


def per_call_us(fn, name, n_calls):
    """Device µs of each of the n_calls launches of kernel `name` that one
    call of fn makes (torch.profiler; mean over 5 calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    times = [float(e.time_range.elapsed_us())
             for e in prof.events()
             if name in e.name and e.device_type.name == "CUDA"]
    if len(times) != 5 * n_calls:
        return []
    return [float(v) for v in np.asarray(times).reshape(5, n_calls).mean(0)]


def ab(gpu, cases):
    """Each case (what, old_fn, new_fn, old kernel names, new kernel names)
    timed old, new, new, old with events; then, after every case has been
    timed that way, each one's kernels under the profiler (a profiled
    process issues ops more slowly afterwards)."""
    results = []
    for what, old_fn, new_fn, _, _ in cases:
        runs = {"old": [], "new": []}
        host = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            ms, h = cuda_ms(old_fn if which == "old" else new_fn)
            runs[which].append(ms)
            host[which].append(h)
        results.append(dict(
            what=what, runs=runs,
            old_ms=float(np.mean(runs["old"])),
            new_ms=float(np.mean(runs["new"])),
            old_host_ms=float(np.mean(host["old"])),
            new_host_ms=float(np.mean(host["new"]))))
    for r, (_, old_fn, new_fn, old_names, new_names) in zip(results, cases):
        r["old_kernel_us"] = kernel_us(old_fn, old_names)
        r["new_kernel_us"] = kernel_us(new_fn, new_names)
        print(f"ab: {r['what']}: old {r['old_ms']:.4f} ms, new "
              f"{r['new_ms']:.4f} ms per call sequence (events, runs "
              f"{r['runs']}); host issue old {r['old_host_ms']:.4f} ms, new "
              f"{r['new_host_ms']:.4f} ms; kernels alone old "
              f"{r['old_kernel_us']:.1f} us, new {r['new_kernel_us']:.1f} us "
              f"(profiler) [{gpu}]", flush=True)
    return results


def same(a, b, what):
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: old and new differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, type=pathlib.Path)
    ap.add_argument("--out", default=str(ROOT / "build" / "ab_kernels" /
                                         "ab_kernels.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_kernels: needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    for name in ("pyramid_dense", "integral_tables", "dense_level"):
        print_ptxas(f"new {name}", _build.build_library(name)[1])
    old = Old(args.old_csrc)

    frames = torch.from_numpy(face_clip(B, *FRAME, seed=11)).to(dev)
    face_work = equalize_hist(resize_linear_exact(frames, (160, 90)))
    part = equalize_hist(resize_linear_exact(frames, (320, 180)))
    face = FaceDetector(FRAME, device=dev).engine
    nose = NoseDetector(FRAME, device=dev).part_engines["nose"]
    eye = EyeDetector(FRAME, device=dev).part_engines["right"]
    mouth = MouthDetector(FRAME, device=dev).part_engines["mouth"]

    def levels(eng):
        return [resize_linear_exact(part, (l.sw, l.sh)) for l in eng.levels]

    eye_l, mouth_l = levels(eye), levels(mouth)
    cases = []
    pyr_names = (["pyramid_dense_kernel"], ["pyramid_band_kernel"])
    for what, work, plan in (("#1 face path, 7 levels 160x90", face_work,
                              face._plan),
                             ("#1 nose launch, 20 levels 219x123 .. 36x20",
                              part, nose._plan)):
        for li, (o, n) in enumerate(zip(old.pyramid(work, plan),
                                        new_pyramid(work, plan))):
            for a, b, name in zip(o, n, ("image", "vnf", "alive")):
                if b is not None:
                    same(a, b, f"{what} level {li} {name}")
        cases.append((what, lambda w=work, p=plan: old.pyramid(w, p),
                      lambda w=work, p=plan: new_pyramid(w, p), *pyr_names))

    int_names = (["integral_tables_kernel"], ["integral_bands_kernel"])
    for what, imgs in (("#4 right eye, 24 levels", eye_l),
                       ("#4 right eye, 6 largest levels", eye_l[:6]),
                       ("#4 mouth, 23 levels", mouth_l)):
        for x in imgs:
            for a, b in zip(old.integral(x), integral_cuda.integral_tables(x)):
                same(a, b, f"{what} {tuple(x.shape)}")
        cases.append((
            what, lambda xs=imgs: [old.integral(x) for x in xs],
            lambda xs=imgs: [integral_cuda.integral_tables(x) for x in xs],
            *int_names))

    plans = [eye._level_plans[li] for li in range(len(eye.levels))]
    tables = []
    for x in eye_l:
        ii, sq = integral_cuda.integral_tables(x)
        tables.append((ii, sq, dense_level_cuda.tilted_table(ii)))
    for t, p in zip(tables, plans):
        for a, b in zip(old.tilted_eval(*t, p),
                        dense_level_cuda._tilted_eval(*t, p)):
            same(a, b, "#2 evaluation")
    cases.append((
        "#2 tiled evaluation, right eye, 24 levels",
        lambda: [old.tilted_eval(*t, p) for t, p in zip(tables, plans)],
        lambda: [dense_level_cuda._tilted_eval(*t, p)
                 for t, p in zip(tables, plans)],
        ["tilted_eval_kernel"], ["tilted_eval_kernel"]))
    for what, lis in (("18 levels 181x102 .. 22x20", range(6, 24)),
                      ("24 levels", range(24)),
                      ("6 largest levels", range(6))):
        cases.append((
            f"#2 tilted dense phase (#4 + tilted table + evaluation), "
            f"right eye, {what}",
            lambda ls=lis: [old.tilted_phase(eye_l[li], plans[li])
                            for li in ls],
            lambda ls=lis: [dense_level_cuda.dense_level_tilted(eye_l[li],
                                                               plans[li])
                            for li in ls],
            ["integral_tables_kernel", "tilted_table_kernel",
             "tilted_eval_kernel"],
            ["integral_bands_kernel", "tilted_table_kernel",
             "tilted_eval_kernel"]))

    results = ab(gpu, cases)
    per_level = {
        "levels": [list(x.shape[1:]) for x in eye_l],
        "old_us": per_call_us(lambda: [old.integral(x) for x in eye_l],
                              "integral_tables_kernel", len(eye_l)),
        "new_us": per_call_us(
            lambda: [integral_cuda.integral_tables(x) for x in eye_l],
            "integral_bands_kernel", len(eye_l))}
    rows = zip(map(tuple, per_level["levels"]), per_level["old_us"],
               per_level["new_us"])
    print(f"ab: #4 per level of the right eye, (h, w): old us, new us: "
          f"{[(hw, round(o, 1), round(n, 1)) for hw, o, n in rows]} "
          f"[{gpu}]",
          flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": gpu, "batch": B, "results": results,
                   "integral_per_level": per_level}, f, indent=1)
    print(f"ab: outputs of old and new equal; numbers in {args.out} [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
