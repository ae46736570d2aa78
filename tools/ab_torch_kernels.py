"""Time two versions of the port's kernels against each other on one CUDA
GPU, in turns.

    python3 tools/ab_torch_kernels.py --old-csrc DIR [--out FILE]

DIR holds an earlier version's ``pyramid_dense.cu``, ``dense_level.cu``,
``dense_eval.cuh`` and ``quant_int8.cu``, in the C interfaces they had
before the pyramid kernel took the row-strip levels (``pyramid_dense_launch``
without the `staged` argument, whose last band of a level tabulates to the
level's end; ``dense_strips_launch``, the row-strip kernel;
``tilted_eval_launch`` as now; ``quant_int8_launch`` with a memset scratch
word and two launches).
The tool builds them with the port's nvcc flags into ``build/ab_kernels/``,
checks that old and new give the same outputs, and times, per B=64 batch
of synthetic 720p frames:

* the pyramid kernel on the face path's 7 levels (160x90);
* the nose's dense phase: old, the 20-level pyramid launch, the plain
  resize of the four wide levels and the row-strip kernel on them; new,
  the one 24-level launch;
* the nose's 24-level launch in its bands (within a third of an SM's
  shared memory) against bands of a window's height and against bands
  within a quarter (all the new kernel);
* the tilted evaluation kernel over the right eye's 24 levels;
* the int8 quantizer over the seven layer inputs of an int8 forward, and
  the stochastic one on the conv1 input; and the new quantizer against
  its variants in ``QUANT_VARIANTS`` (two launches with the same slot and
  a reverse second pass; 1 to 16 groups of 4 a thread in registers),
  built from the port's ``csrc/quant_int8.cu``, which they include;

each as old, new, new, old with CUDA events around 50 calls (mean ms per
call sequence, host issue included) and the host's time to issue them,
and each version's kernel time alone from ``torch.profiler`` (device µs
summed over the kernels of one call sequence; for the quantizers also per
layer input). Every line carries the
card's ``nvidia-smi`` name and power limit; FILE (default
``build/ab_kernels/ab_kernels.json``) gets the numbers.
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
    EyeDetector, FaceDetector, NoseDetector, QuantizedCnnFaceDetector)
from nubomedia_vca_tpu_torch.ops.cuda import (  # noqa: E402
    _build, dense_cuda, dense_level_cuda, integral_cuda, quant_cuda)
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist  # noqa: E402
from nubomedia_vca_tpu_torch.ops.resize import (  # noqa: E402
    resize_linear_exact)
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

B, FRAME, N_CALLS = 64, (1280, 720), 50
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
U, LL = ctypes.c_uint, ctypes.c_longlong
VARIANTS = (0, 1, 2, 4, 8, 16)   # QUANT_VARIANTS: two launches; K groups
CASCADE = [P, P, P, P, I, P, I, I, I, F, F]   # feat_i .. var_thr
# Variants of the int8 quantizer for the A/B cases, sharing its arithmetic
# (load_group, publish_max, scale_of, store_group): variant 0, two launches
# (absmax_slot_kernel into the same epoch-tagged slot, no memset, then
# quantize_reverse_kernel, each thread's groups in the reverse order of the
# first pass); variant K > 0, the port's quant_kernel<K> with K groups of 4
# elements a thread in registers across the grid barrier.
QUANT_VARIANTS = """\
#include "{quant_src}"

namespace {{

__global__ void __launch_bounds__(kThreads)
absmax_slot_kernel(const float* __restrict__ x, long long n, int vec,
                   unsigned long long* slot, unsigned epoch) {{
  const long long T = static_cast<long long>(gridDim.x) * kThreads;
  long long last;
  publish_max(stream_max(x, n, vec,
                         static_cast<long long>(blockIdx.x) * kThreads +
                             threadIdx.x,
                         (n + 3) / 4, T, &last),
              slot, epoch);
}}

__global__ void __launch_bounds__(kThreads)
quantize_reverse_kernel(const float* __restrict__ x, long long n, int vec,
                        const unsigned long long* slot, int stochastic,
                        unsigned seed, int8_t* __restrict__ q,
                        float* __restrict__ scale_out) {{
  const long long T = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long n_groups = (n + 3) / 4;
  const float scale = scale_of(static_cast<unsigned>(__ldcg(slot)));
  if (t == 0) *scale_out = scale;
  if (t >= n_groups) return;
  stream_quantize(x, q, n, vec, t, t + (n_groups - 1 - t) / T * T, T, scale,
                  stochastic, seed);
}}

const void* fused(int k) {{
  switch (k) {{
    case 1: return reinterpret_cast<const void*>(quant_kernel<1>);
    case 2: return reinterpret_cast<const void*>(quant_kernel<2>);
    case 4: return reinterpret_cast<const void*>(quant_kernel<4>);
    case 8: return reinterpret_cast<const void*>(quant_kernel<8>);
    case 16: return reinterpret_cast<const void*>(quant_kernel<16>);
    default: return nullptr;
  }}
}}

}}  // namespace

// Resident blocks of a variant on `device` (its SMs times the blocks an SM
// holds). Returns the CUDA error code (0 on success; 1 for no such variant).
extern "C" int quant_ab_max_blocks(int variant, int device, int* blocks) {{
  const void* kernel = variant == 0
                           ? reinterpret_cast<const void*>(absmax_slot_kernel)
                           : fused(variant);
  if (kernel == nullptr) return 1;
  int n_sm = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = n_sm * per_sm;
  return 0;
}}

// One call of a variant, arguments as quant_int8_launch's.
extern "C" int quant_ab_launch(int variant, int device, void* stream,
                               const float* x, long long n, int stochastic,
                               unsigned seed, int blocks,
                               unsigned long long* slot, unsigned epoch,
                               int8_t* q, float* scale_out) {{
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(q) % 4 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {{
    absmax_slot_kernel<<<blocks, kThreads, 0, s>>>(x, n, vec, slot, epoch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    quantize_reverse_kernel<<<blocks, kThreads, 0, s>>>(
        x, n, vec, slot, stochastic, seed, q, scale_out);
    return static_cast<int>(cudaGetLastError());
  }}
  const void* kernel = fused(variant);
  if (kernel == nullptr) return 1;
  void* args[] = {{&x, &n, &vec, &slot, &epoch, &stochastic, &seed, &q,
                  &scale_out}};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), args, 0, s));
}}
"""


def build(src: pathlib.Path, out_name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "ab_kernels" / f"lib{out_name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, check=True, capture_output=True, text=True)
    print_ptxas(out_name, proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


def print_ptxas(what: str, log: str) -> None:
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas ({what}): {line.strip()}", flush=True)


def stream_args(dev):
    return dense_cuda.device_index(dev), torch.cuda.current_stream(
        dev).cuda_stream


def old_strip_plan(l, win_h):
    """The row-strip kernel's strips of a level: (strip_gy, n_strips, rows
    a strip tabulates)."""
    max_rows = dense_cuda.MAX_SMEM_BYTES // (8 * (l.sw + 1)) - 1
    gy = l.sh - win_h + 1
    strip_gy = (max_rows - win_h + 1) // l.ystep * l.ystep
    strip_gy = min(strip_gy, -(-gy // l.ystep) * l.ystep)
    return strip_gy, -(-gy // strip_gy), min(strip_gy + win_h - 1, l.sh)


class Old:
    """The earlier version's wrappers: its launchers, bound with their C
    interfaces, behind the same checks, allocations and output views as
    the current wrappers, so that both sides pay the same host work."""

    def __init__(self, src_dir: pathlib.Path):
        self.pyr = build(src_dir / "pyramid_dense.cu", "pyramid_dense_old")
        self.pyr.pyramid_dense_launch.argtypes = [
            I, P, P, I, I, I, P, P, I, P, P, I, P, I, I, I, F, F, I, P, P, P]
        self.level = build(src_dir / "dense_level.cu", "dense_level_old")
        self.level.tilted_eval_launch.argtypes = \
            dense_level_cuda._library().tilted_eval_launch.argtypes
        self.level.dense_strips_launch.argtypes = [
            I, P, P, I, I, I, I, I, I, I, I, I, *CASCADE, I, P, P]
        self.quant = build(src_dir / "quant_int8.cu", "quant_int8_old")
        self.quant.quant_int8_launch.argtypes = [I, P, P, LL, I, U, P, P, P]
        self._tabs: dict = {}

    def _plan_tables(self, plan, dev):
        """The plan's items as the old kernel reads them, and its shared
        memory."""
        key = (id(plan), dev)
        if key not in self._tabs:
            items = plan.items.copy()
            n_rec = len(plan.tables.host["weak_i"]) * dense_cuda.TREE_WORDS
            for it in items:
                l = plan.levels[it[0]]
                if it[1] + it[2] == l.ny:          # the last band: to the end
                    it[4] = l.sh - it[3]
            smem = 4 * (n_rec + plan.tables.n_dense) + max(
                8 * (it[4] + 1) * (plan.levels[it[0]].sw + 1) for it in items)
            assert smem <= dense_cuda.MAX_SMEM_BYTES
            self._tabs[key] = (torch.from_numpy(items).to(dev), smem)
        return self._tabs[key]

    def pyramid(self, work, plan):
        dense_cuda._check_work(work, plan)
        dev = work.device
        items, smem = self._plan_tables(plan, dev)
        t, tabs = plan.device_tables(dev), plan.tables
        img = torch.empty(max(B * plan.img_unit, 1), dtype=torch.uint8,
                          device=dev)
        vnf = torch.empty(B * plan.map_unit, dtype=torch.float32, device=dev)
        alive = torch.empty(B * plan.map_unit, dtype=torch.uint8, device=dev)
        rc = self.pyr.pyramid_dense_launch(
            *stream_args(dev), work.data_ptr(), B, plan.image_h, plan.image_w,
            t["levels"].data_ptr(), items.data_ptr(), len(plan.items),
            t["rtab"].data_ptr(), t["records"].data_ptr(),
            len(tabs.host["weak_i"]),
            tabs.device_tables(dev)["stage_thr"].data_ptr(), tabs.n_dense,
            tabs.norm_w, tabs.norm_h, tabs.norm_area, tabs.var_thr, smem,
            img.data_ptr(), vnf.data_ptr(), alive.data_ptr())
        assert rc == 0, rc
        return dense_cuda.level_outputs(plan, B, img, vnf, alive)

    def strips(self, img, l, tables):
        """The row-strip kernel on level image img [B, sh, sw] → (vnf,
        alive)."""
        dev = img.device
        strip_gy, n_strips, rows = old_strip_plan(l, tables.window_h)
        t = tables.device_tables(dev)
        vnf = torch.empty((B, l.ny, l.nx), dtype=torch.float32, device=dev)
        alive = torch.empty((B, l.ny, l.nx), dtype=torch.uint8, device=dev)
        rc = self.level.dense_strips_launch(
            *stream_args(dev), img.data_ptr(), B, l.sh, l.sw, l.ystep, l.nx,
            l.ny, strip_gy, n_strips, tables.window_h, t["feat_i"].data_ptr(),
            t["feat_w"].data_ptr(), t["weak_i"].data_ptr(),
            t["weak_f"].data_ptr(), t["weak_i"].shape[0],
            t["stage_thr"].data_ptr(), tables.n_dense, tables.norm_w,
            tables.norm_h, tables.norm_area, tables.var_thr,
            8 * (rows + 1) * (l.sw + 1), vnf.data_ptr(), alive.data_ptr())
        assert rc == 0, rc
        return vnf, alive

    def tilted_eval(self, ii, sq, iit, plan):
        lib = dense_level_cuda._library
        dense_level_cuda._library = lambda: self.level
        try:
            return dense_level_cuda._tilted_eval(ii, sq, iit, plan)
        finally:
            dense_level_cuda._library = lib

    def quantize(self, x, stochastic=False, seed=0):
        quant_cuda._check(x)
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scale = torch.empty((), dtype=torch.float32, device=x.device)
        scratch = torch.empty(1, dtype=torch.int32, device=x.device)
        rc = self.quant.quant_int8_launch(
            *stream_args(x.device), x.data_ptr(), x.numel(), int(stochastic),
            seed, scratch.data_ptr(), q.data_ptr(), scale.data_ptr())
        assert rc == 0, rc
        return q, scale


class Variants:
    """The quantizer variants of QUANT_VARIANTS behind the current
    wrapper's host work (cached grid, the stream's slot)."""

    def __init__(self):
        src = ROOT / "build" / "ab_kernels" / "quant_variants.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(QUANT_VARIANTS.format(
            quant_src=_build.SRC_DIR / "quant_int8.cu"))
        self.lib = build(src, "quant_variants")
        self.lib.quant_ab_launch.argtypes = [I, I, P, P, LL, I, U, I, P, U,
                                             P, P]
        self.lib.quant_ab_max_blocks.argtypes = [I, I,
                                                 ctypes.POINTER(ctypes.c_int)]
        self._most: dict = {}

    def most(self, variant, dev):
        if variant not in self._most:
            out = ctypes.c_int(0)
            assert self.lib.quant_ab_max_blocks(variant, dev,
                                                ctypes.byref(out)) == 0
            self._most[variant] = out.value
        return self._most[variant]

    def quantize(self, x, variant, stochastic=False, seed=0):
        quant_cuda._check(x)
        dev, stream = stream_args(x.device)
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scale = torch.empty((), dtype=torch.float32, device=x.device)
        slot, epoch = quant_cuda._slot(x.device, stream).take()
        groups = -(-x.numel() // 4)
        per = quant_cuda.THREADS * max(variant, 1)
        blocks = max(1, min(self.most(variant, dev), -(-groups // per)))
        rc = self.lib.quant_ab_launch(
            variant, dev, stream, x.data_ptr(), x.numel(), int(stochastic),
            seed, blocks, slot, epoch, q.data_ptr(), scale.data_ptr())
        assert rc == 0, rc
        return q, scale


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


def per_launch_us(fn, names):
    """Device µs of each launch of the kernels whose names contain one of
    `names` in one call of fn, in launch order (torch.profiler; mean over
    5 calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, float(e.time_range.elapsed_us()))
                 for e in prof.events()
                 if e.device_type.name == "CUDA"
                 and any(n in e.name for n in names))
    us = np.asarray([d for _, d in evs])
    return [float(v) for v in us.reshape(5, -1).mean(0)] if len(us) % 5 == 0 \
        else []


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


def dense_cases(old, face, nose, eye, face_work, part):
    """The dense kernels' cases, each checked old == new first."""
    cases = []
    pyr = ["pyramid_band_kernel"]
    for li, (o, n) in enumerate(zip(old.pyramid(face_work, face._plan),
                                    dense_cuda.pyramid_dense_phase(
                                        face_work, face._plan))):
        for a, b, name in zip(o, n, ("image", "vnf", "alive")):
            if b is not None:
                same(a, b, f"#1 face level {li} {name}")
    cases.append(("#1 face path, 7 levels 160x90",
                  lambda: old.pyramid(face_work, face._plan),
                  lambda: dense_cuda.pyramid_dense_phase(face_work,
                                                         face._plan),
                  pyr, pyr))

    wide, tabs = nose.levels[:4], nose._tables
    plan20 = dense_cuda.PyramidDensePlan((320, 180), nose.levels[4:], tabs)
    assert plan20.n_wide == 0 and nose._plan.n_wide == 4

    def old_nose():
        out = []
        for l in wide:
            img = (part if (l.sw, l.sh) == (320, 180)
                   else resize_linear_exact(part, (l.sw, l.sh)))
            out.append((img, *old.strips(img, l, tabs)))
        return out + old.pyramid(part, plan20)

    def new_nose():
        return dense_cuda.pyramid_dense_phase(part, nose._plan)

    for li, (o, n) in enumerate(zip(old_nose(), new_nose())):
        for a, b, name in zip(o, n, ("image", "vnf", "alive")):
            if b is not None:
                same(a, b, f"nose level {li} {name}")
    cases.append((
        "#1 + #3 nose dense phase: old 20-level launch + 4 resizes + 4 "
        f"row-strip launches, new one 24-level launch "
        f"({len(nose._plan.items)} bands)",
        old_nose, new_nose, [""], [""]))
    for what, target in (
            ("bands of a window's height", dense_cuda.MAX_SMEM_BYTES),
            ("bands within a quarter of an SM's shared memory",
             dense_cuda.SM_SMEM_BYTES // 4 - 1024)):
        other = dense_cuda.PyramidDensePlan((320, 180), nose.levels, tabs,
                                            band_target=target)
        for a, b in zip(dense_cuda.pyramid_dense_phase(part, nose._plan),
                        dense_cuda.pyramid_dense_phase(part, other)):
            for x, y in zip(a, b):
                if x is not None:
                    same(x, y, f"nose, {what}")
        cases.append((
            f"#1 nose 24-level launch: old = {what} ({len(other.items)} "
            f"bands, {other.band_smem_bytes} B a block); new = the port's "
            f"bands ({len(nose._plan.items)} bands, "
            f"{nose._plan.band_smem_bytes} B)",
            lambda p=other: dense_cuda.pyramid_dense_phase(part, p),
            new_nose, pyr, pyr))

    plans = [eye._level_plans[li] for li in range(len(eye.levels))]
    tables = []
    for l in eye.levels:
        ii, sq = integral_cuda.integral_tables(
            resize_linear_exact(part, (l.sw, l.sh)))
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
    return cases


def quant_cases(old, variants, xs):
    """The quantizers' cases, each checked old == new first."""
    new_q = ["quant_kernel"]
    for x in xs:
        for a, b in zip(old.quantize(x), quant_cuda.quantize_int8(x)):
            same(a, b, f"#5 {x.numel()} elements")
        for v in VARIANTS:
            for a, b in zip(variants.quantize(x, v),
                            quant_cuda.quantize_int8(x)):
                same(a, b, f"#5 variant {v}, {x.numel()} elements")
    x1 = xs[1]
    for a, b in zip(old.quantize(x1, True, 1),
                    quant_cuda.quantize_int8_stochastic(x1, 1)):
        same(a, b, "#6 conv1 input")
    cases = [
        ("#5 int8 quantizer, 7 layer inputs (49.2M elements)",
         lambda: [old.quantize(x) for x in xs],
         lambda: [quant_cuda.quantize_int8(x) for x in xs],
         ["absmax_kernel", "quantize_kernel"], new_q),
        ("#6 stochastic quantizer, conv1 input (19.7M elements)",
         lambda: old.quantize(x1, True, 1),
         lambda: quant_cuda.quantize_int8_stochastic(x1, 1),
         ["absmax_kernel", "quantize_kernel"], new_q)]
    for v in VARIANTS:
        what = ("two launches (max; reverse re-read), same slot" if v == 0
                else f"one launch, {v} groups of 4 a thread in registers")
        cases.append((
            f"#5 over the 7 inputs: old = {what}; new = the port's one "
            f"launch, {quant_cuda.REG_GROUPS} groups",
            lambda v=v: [variants.quantize(x, v) for x in xs],
            lambda: [quant_cuda.quantize_int8(x) for x in xs],
            ["absmax_slot_kernel", "quantize_reverse_kernel"] if v == 0
            else new_q, new_q))
    return cases


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
    for name in ("pyramid_dense", "dense_level", "integral_tables",
                 "quant_int8"):
        print_ptxas(f"new {name}", _build.build_library(name)[1])
    old = Old(args.old_csrc)
    variants = Variants()

    frames = torch.from_numpy(face_clip(B, *FRAME, seed=11)).to(dev)
    face_work = equalize_hist(resize_linear_exact(frames, (160, 90)))
    part = equalize_hist(resize_linear_exact(frames, (320, 180)))
    face = FaceDetector(FRAME, device=dev).engine
    nose = NoseDetector(FRAME, device=dev).part_engines["nose"]
    eye = EyeDetector(FRAME, device=dev).part_engines["right"]
    qdet = QuantizedCnnFaceDetector(FRAME, device=dev)
    taps = []
    qdet.model(qdet.letterbox(frames), taps)
    xs = [x for x, _, _ in taps]

    results = ab(gpu, dense_cases(old, face, nose, eye, face_work, part)
                 + quant_cases(old, variants, xs))
    per_input = {
        "elements": [x.numel() for x in xs],
        "old_us": per_launch_us(lambda: [old.quantize(x) for x in xs],
                                ["absmax_kernel", "quantize_kernel"]),
        "new_us": per_launch_us(
            lambda: [quant_cuda.quantize_int8(x) for x in xs],
            ["quant_kernel"]),
        "two_launch_us": per_launch_us(
            lambda: [variants.quantize(x, 0) for x in xs],
            ["absmax_slot_kernel", "quantize_reverse_kernel"])}
    print(f"ab: #5 per layer input, kernel us: {per_input} [{gpu}]",
          flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": gpu, "batch": B, "results": results,
                   "quant_per_input": per_input}, f, indent=1)
    print(f"ab: outputs of old and new equal; numbers in {args.out} [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
