"""The multi-device dry run: the port of
``__graft_entry__.dryrun_multichip``.

One process per device joins a process group (NCCL on cards, one process
per card; gloo on the CPU) and runs, over an ('data', 'model') mesh, the
four multi-device steps of the JAX package's dry run:

1. the learned detector's dp×tp train step (``make_sharded_train_step``),
   at a constant lr and on the recipe's warmup-cosine schedule with a
   resume from the gathered, saved optimizer and scheduler state;
2. sharded cascade detection (``make_sharded_detect``);
3. the serving step: 4 streams pushed into a ``StreamFeeder``, one drained
   batch through sharded detection and grouping
   (``make_sharded_detect_grouped``), grouped boxes gathered;
4. the sharded part chain: the grouped face pass plus the tilted
   ``haarcascade_lefteye_2splits`` at factor 1.1, candidates compacted on
   the device (``make_sharded_chain``).

    python -m nubomedia_vca_tpu_torch.parallel.dryrun 4 --device cpu
    python -m nubomedia_vca_tpu_torch.parallel.dryrun 1          # one card

The cascades are the port's bundled copies. Every process also runs the
unsharded path on its device and holds the sharded outputs to it:
detection exactly, the train step within ``LOSS_RTOL`` and the parameter
bounds below. On an even count of devices the mesh is (n/2) x 2, the CNN
head split in two; otherwise n x 1. A CUDA request raises without a card
or with fewer cards than processes: nothing drops to gloo or to fewer
ranks.
"""

from __future__ import annotations

import dataclasses
import io
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..cascade.engine import CascadeEngine, _resolve_device, load_cascade
from ..cascade.paths import find_cascade
from ..models import cnn
from ..ops.cuda import dense_cuda, dense_level_cuda, integral_cuda
from ..pipeline.scheduler import StreamFeeder
from .mesh import init_distributed, make_mesh, mesh_device
from .sharded import (TensorParallelCnnNet, full_optimizer_state,
                      make_sharded_chain, make_sharded_detect,
                      make_sharded_detect_grouped, make_sharded_train_step)

# the sharded train step against the unsharded one on the same device:
# the loss (relative), and the parameters after k steps, max |Δ| within
# 2·Σ lr (Adam's first updates are ±lr whatever a gradient's size) and a
# median |Δ| within lr / 1000
LOSS_RTOL = 1e-5
PARAM_MEDIAN = 3e-4 / 1000
LR = 3e-4
SCHEDULE_STEPS = 10    # the warmup-cosine run's length (warmup 1 step)
# the kernels of these paths, by the wrapper attribute that counts them
COUNTERS = {
    "pyramid_dense_phase": (dense_cuda.pyramid_dense_phase, "launches"),
    "pyramid_dense_phase_wide": (dense_cuda.pyramid_dense_phase,
                                 "wide_launches"),
    "dense_level_tilted": (dense_level_cuda.dense_level_tilted, "launches"),
    "tilted_table": (dense_level_cuda.tilted_table, "launches"),
    "integral_tables": (integral_cuda.integral_tables, "launches"),
}


@dataclasses.dataclass
class DryrunInputs:
    """What every process gets whole (each takes its shard): detection
    frames at the face engine's size, part images at the part engine's,
    the serving frames (pushed round robin over `n_streams`), and a
    training batch with its boxes and the CNN's nested parameters."""
    face: np.ndarray            # [B, fh, fw] uint8
    part: np.ndarray            # [B, ph, pw] uint8
    serve: np.ndarray           # [B, fh, fw] uint8
    train_gray: np.ndarray      # [Bt, H, W] uint8
    train_boxes: np.ndarray     # [Bt, K, 4] float32, x y w h
    train_valid: np.ndarray     # [Bt, K] bool
    params: dict                # nested float32 numpy (cnn.init_params)
    train_steps: int = 1
    n_streams: int = 4
    face_cascade: str = "haarcascade_frontalface_alt.xml"
    face_factor: float = 1.25
    part_cascade: str = "haarcascade_lefteye_2splits.xml"
    part_factor: float = 1.1


def small_inputs(n_devices: int, seed: int = 0) -> DryrunInputs:
    """The JAX dry run's shapes: 2·n frames of 64x48 noise for detection
    and the chain, max(2·n, 4) for serving (a frame from each of the 4
    streams at least); a train batch of 64x64 frames, a multiple of n and
    at least 4, with two boxes each, the second left out in its later
    half (so that data shards hold different numbers of boxes); CNN
    channels (8, 8, 8, 8), the context conv, head width 16·n_model."""
    n_model = default_n_model(n_devices)
    rng = np.random.RandomState(seed)
    b, bt = 2 * n_devices, n_devices * -(-4 // n_devices)
    boxes = rng.randint(0, 32, (bt, 2, 4)).astype(np.float32)
    boxes[..., 2:] += 8.0
    valid = np.ones((bt, 2), bool)
    valid[bt // 2:, 1] = False          # later shards: fewer boxes
    params = cnn.init_params(torch.Generator().manual_seed(seed),
                             channels=(8, 8, 8, 8), head_dim=16 * n_model,
                             ctx=True)
    return DryrunInputs(
        face=rng.randint(0, 256, (b, 48, 64)).astype(np.uint8),
        part=rng.randint(0, 256, (b, 48, 64)).astype(np.uint8),
        serve=rng.randint(0, 256, (max(b, 4), 48, 64)).astype(np.uint8),
        train_gray=rng.randint(0, 256, (bt, 64, 64)).astype(np.uint8),
        train_boxes=boxes, train_valid=valid, params=params, train_steps=2)


def default_n_model(n_devices: int) -> int:
    """2 on an even count of devices (the head split in two), else 1."""
    return 2 if n_devices % 2 == 0 else 1


# ------------------------------------------------------------ processes
def _rank_entry(rank, world, init_method, device_type, n_model, fn, args,
                results) -> None:
    """One process of the group: join it, build the mesh, run
    fn(mesh, *args), report (rank, ok, (setup seconds, result) or the
    traceback)."""
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        t0 = time.perf_counter()
        init_distributed(init_method, world, rank, device_type)
        try:
            mesh = make_mesh(world // n_model, n_model, device_type)
            warm = torch.zeros(1, device=mesh_device(mesh))
            dist.all_reduce(warm)                 # the communicator is up
            setup_s = time.perf_counter() - t0
            results.put((rank, True, (setup_s, fn(mesh, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, n_devices: int, device_type: str, n_model: int = 1,
                args: tuple = (), timeout: float = 600.0) -> list:
    """Run fn(mesh, *args) in `n_devices` spawned processes of one group
    (NCCL on cards, one per card; gloo on the CPU) → [(setup seconds,
    result)] by rank. `fn` must be importable (a module-level function).
    Raises if a process fails or the run outlasts `timeout`; every
    process is stopped before this returns."""
    if device_type == "cuda":
        _resolve_device("cuda")
        if n_devices > torch.cuda.device_count():
            raise ValueError(
                f"{n_devices} processes need {n_devices} cards, this host "
                f"has {torch.cuda.device_count()} (NCCL takes one card a "
                "process)")
    elif device_type != "cpu":
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if n_devices % n_model:
        raise ValueError(f"n_model {n_model} does not divide {n_devices}")
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict[int, tuple] = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
            r, n_devices, init, device_type, n_model, fn, args, results))
            for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n_devices:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n_devices)) - set(got))} "
                        f"gave no result within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 2.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited without a "
                                           "result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
        finally:
            _stop(procs, grace=30.0 if len(got) == n_devices else 0.5)
            results.close()
            results.cancel_join_thread()
    return [got[r] for r in range(n_devices)]


def _stop(procs, grace: float) -> None:
    """Join `procs` within `grace` seconds, then terminate and at last kill
    what is left; every wait is bounded."""
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.0))
    for signal in ("terminate", "kill"):
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            getattr(p, signal)()
        for p in alive:
            p.join(timeout=10)


# ------------------------------------------------------------- the steps
def read_counts() -> dict[str, int]:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def _counted(fn, counts: dict):
    """Call fn(); add the kernel launches it made to `counts`."""
    before = read_counts()
    out = fn()
    for k, v in read_counts().items():
        counts[k] = counts.get(k, 0) + v - before[k]
    return out


def _np(outputs):
    if isinstance(outputs, dict):
        return {k: _np(v) for k, v in outputs.items()}
    if isinstance(outputs, tuple):
        return tuple(_np(v) for v in outputs)
    if isinstance(outputs, torch.Tensor):
        return outputs.cpu().numpy()
    return outputs


def _ms(fn, dev: torch.device, n: int) -> float:
    """Mean ms of fn() over n calls after a warm one (CUDA events on a
    card, the host clock on the CPU)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def _equal(got, want, what: str) -> None:
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        for k in want:
            _equal(got[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
        return
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: the sharded output differs from the "
                             f"unsharded one in {int((got != want).sum())} "
                             "elements")


def params_gap(got: dict, want: dict) -> tuple[float, float]:
    """(max, median) |difference| of two nested parameter dicts."""
    d = np.concatenate([np.abs(got[n][k] - want[n][k]).ravel()
                        for n in want for k in want[n]])
    return float(d.max()), float(np.median(d))


def _unsharded_run(inp: DryrunInputs, batch, n: int, steps=None):
    """`n` steps of the unsharded ``cnn.train_step`` from ``inp.params``
    (constant lr, or warmup-cosine over `steps`) → (losses, model,
    optimizer, scheduler)."""
    ref = cnn.CnnNet(inp.params).to(batch[0].device)
    opt, sched = cnn.make_optimizer(ref.parameters(), LR, steps)
    losses = [float(cnn.train_step(ref, opt, sched, *batch)[0])
              for _ in range(n)]
    return losses, ref, opt, sched


def _check_run(losses, want, got_params, ref, lr_sum: float) -> dict:
    """The sharded run against the unsharded one: losses within
    ``LOSS_RTOL`` relative, parameters within 2·Σ lr (max) and
    ``PARAM_MEDIAN`` (median); raises past them → the gaps."""
    gap = max(abs(g - w) / abs(w) for g, w in zip(losses, want))
    pmax, pmed = params_gap(got_params, cnn.params_to_numpy(ref.state_dict()))
    check = {"loss_rel": gap, "param_max": pmax, "param_median": pmed,
             "lr_sum": lr_sum}
    if gap > LOSS_RTOL or pmax > 2 * lr_sum or pmed > PARAM_MEDIAN:
        raise AssertionError(f"sharded train step against unsharded: {check}")
    return check


def _train(mesh, inp: DryrunInputs, timed: int, dev) -> dict:
    """The dp×tp train step, `inp.train_steps` steps on one batch at a
    constant lr, held against the unsharded ``cnn.train_step`` on the
    same device; then the recipe's warmup-cosine schedule over
    ``SCHEDULE_STEPS``: `inp.train_steps` sharded steps, their whole
    state gathered, a new sharded step resumed from it for as many more,
    held against one uninterrupted unsharded run on that schedule. The
    resumed step takes an (optimizer, scheduler) pair built over its own
    model and the state as read back from a file."""
    gray = torch.from_numpy(inp.train_gray).to(dev)
    _, h, w = inp.train_gray.shape
    obj_t, reg_t = cnn.boxes_to_targets(
        torch.from_numpy(inp.train_boxes).to(dev),
        torch.from_numpy(inp.train_valid).to(dev), h, w)
    batch = (gray, obj_t, reg_t)
    k = inp.train_steps
    step, model, _ = make_sharded_train_step(mesh, inp.params, LR)
    losses = [float(step(*batch)[0]) for _ in range(k)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training step produced {losses}")
    out = {"train_losses": losses, "train_params": model.full_params()}
    want, ref, opt, sched = _unsharded_run(inp, batch, k)
    out["train_check"] = _check_run(losses, want, out["train_params"], ref,
                                     LR * k)

    # warmup-cosine: k sharded steps, the whole state, k resumed steps
    n = SCHEDULE_STEPS
    s_step, s_model, (s_opt, s_sched) = make_sharded_train_step(
        mesh, inp.params, LR, steps=n)
    sched_losses = [float(s_step(*batch)[0]) for _ in range(k)]
    buf = io.BytesIO()        # through torch.save and load, as a file is
    torch.save({"optimizer": full_optimizer_state(s_model, s_opt),
                "scheduler": s_sched.state_dict()}, buf)
    buf.seek(0)
    r_model = TensorParallelCnnNet(s_model.full_params(), mesh)
    r_step, _, _ = make_sharded_train_step(
        mesh, r_model, optimizer=cnn.make_optimizer(r_model.parameters(), LR,
                                                    n),
        state=torch.load(buf, map_location=dev, weights_only=True))
    sched_losses += [float(r_step(*batch)[0]) for _ in range(k)]
    out["schedule_losses"] = sched_losses
    out["schedule_params"] = r_model.full_params()
    factor = cnn.warmup_cosine(n)
    s_want, s_ref, _, _ = _unsharded_run(inp, batch, 2 * k, n)
    out["schedule_check"] = _check_run(
        sched_losses, s_want, out["schedule_params"], s_ref,
        LR * sum(factor(i) for i in range(2 * k)))
    if timed:
        out["ms"] = {"train_step": _ms(lambda: step(*batch), dev, timed),
                     "train_step_unsharded": _ms(lambda: cnn.train_step(
                         ref, opt, sched, *batch), dev, timed)}
    return out


def _dryrun_rank(mesh, inp: DryrunInputs, timed: int) -> dict:
    """The four steps on this process's shards (see the module
    docstring), each held against the unsharded path → its outputs
    (numpy, whole batch), the kernel launches of the sharded calls, and
    with `timed` the ms of both paths."""
    dev = mesh_device(mesh)
    out = _train(mesh, inp, timed, dev)
    counts: dict[str, int] = {}

    # ---- sharded detection step (dp over streams) ----
    fh, fw = inp.face.shape[1:]
    face_eng = CascadeEngine(load_cascade(find_cascade(inp.face_cascade)),
                             (fw, fh), inp.face_factor, device=dev)
    detect = make_sharded_detect(face_eng, mesh)
    out["detect"] = _np(_counted(lambda: detect(inp.face), counts))

    # ---- serving step: multi-stream feeder → sharded detect+group ----
    b = inp.serve.shape[0]
    feeder = StreamFeeder(fw, fh, batch=b)
    try:
        for i in range(b):
            feeder.push(i % inp.n_streams, inp.serve[i], pts=i)
        frames, _, streams, n_real = feeder.next_batch()
    finally:
        feeder.ingest.close()
    if n_real != b or len(set(streams.tolist())) != inp.n_streams:
        raise AssertionError(f"feeder drained {n_real} of {b} frames from "
                             f"streams {sorted(set(streams.tolist()))}")
    serve = make_sharded_detect_grouped(face_eng, mesh, min_neighbors=3)
    out["serve"] = _np(_counted(lambda: serve(frames), counts))
    out["serve_frames"], out["serve_streams"] = frames, streams

    # ---- part chain: grouped face pass + tilted sf=1.1 part engine ----
    ph, pw = inp.part.shape[1:]
    part_eng = CascadeEngine(load_cascade(find_cascade(inp.part_cascade)),
                             (pw, ph), inp.part_factor, device=dev)
    chain = make_sharded_chain(face_eng, {"eye_left": part_eng}, mesh,
                               min_neighbors=3)
    out["chain"] = _np(_counted(lambda: chain(inp.face, inp.part), counts))
    out["launches"] = counts

    # ---- the unsharded path on the whole batch ----
    whole = {k: torch.from_numpy(getattr(inp, k)).to(dev)
             for k in ("face", "part")}
    sframes = torch.from_numpy(frames).to(dev)

    def serve_ref():
        return face_eng._group_impl(*face_eng._detect_impl(sframes),
                                    min_neighbors=3)

    def chain_ref():
        return (face_eng._group_impl(*face_eng._detect_impl(whole["face"]),
                                     min_neighbors=3),
                {"eye_left": part_eng._compact_raw_impl(
                    *part_eng._detect_impl(whole["part"]))})

    _equal(out["detect"], face_eng._detect_impl(whole["face"]), "detect")
    _equal(out["serve"], serve_ref(), "serve")
    _equal(out["chain"], chain_ref(), "chain")
    if timed:
        out["ms"].update({
            "detect_grouped": _ms(lambda: serve(frames), dev, timed),
            "detect_grouped_unsharded": _ms(serve_ref, dev, timed),
            "chain": _ms(lambda: chain(inp.face, inp.part), dev, timed),
            "chain_unsharded": _ms(chain_ref, dev, timed)})
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     inputs: DryrunInputs | None = None, timed: int = 0,
                     timeout: float = 600.0) -> list[dict]:
    """Run the four steps over `n_devices` processes, one per device:
    NCCL ranks on cards (raises with fewer cards than `n_devices` or no
    card), gloo ranks for ``device="cpu"``. `inputs` default to the JAX
    dry run's small shapes; with `timed`, each process also times that
    many calls of each sharded and unsharded step. Raises if an output
    differs from the unsharded path. Returns each rank's report
    (``_dryrun_rank``), each with "setup_s", the seconds to join the
    group, build the mesh and run a first collective."""
    device_type = torch.device(device).type
    n_model = default_n_model(n_devices)
    inputs = inputs or small_inputs(n_devices)
    ranks = spawn_ranks(_dryrun_rank, n_devices, device_type, n_model,
                        (inputs, timed), timeout)
    reports = []
    for setup_s, rep in ranks:
        rep["setup_s"] = setup_s
        reports.append(rep)
    r0 = reports[0]
    print(f"dryrun_multichip({n_devices}, {device_type}): mesh "
          f"{n_devices // n_model}x{n_model}; train loss "
          f"{r0['train_losses'][-1]:.4f}; detect boxes "
          f"{r0['detect'][0].shape}; serving {inputs.n_streams}-stream "
          f"grouped boxes {r0['serve'][0].shape}; part-chain eye_left "
          f"compacted candidates {r0['chain'][1]['eye_left'][0].shape}; "
          "sharded == unsharded OK", flush=True)
    return reports


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = ap.parse_args(argv)
    dryrun_multichip(ns.n_devices, ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
