"""The least time the card could take for a cascade's dense phase, from
the work the frames need, and the roofline share it gives.

The count follows the program's ``bench_torch.frame_bytes`` /
``cascade_bytes`` and ``chip_smoke.bound`` (bytes read once and written
once over 3.35 TB/s, operations over 67 TFLOP/s of float32 outside the
tensor cores, on an H100 SXM at 700 W), restricted to the dense phase and
made independent of how a kernel implements it:

* the dense phase of a cascade is its first stages whose trees number
  at most 48 together (at least one stage), on every window of every
  pyramid level;
* bytes: each frame's input image is read once (the work image where the
  phase also makes the level images; each level's image where the levels
  are made before it), and per window the variance factor (4 B) and the
  pass flag (1 B) are written once;
* operations: per window the variance test (two 4-corner rect sums, the
  variance, its comparison, a square root and a reciprocal: 12), and per
  stage that the window enters (it leaves at the first stage it fails) the
  stage's trees, each its deepest path of nodes (a node: per rect 3
  additions and a multiply, the rects' sum, the product with the variance
  factor and the comparison) plus the leaf's addition, and the stage's
  comparison.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
DENSE_MAX_TREES = 48
VARIANCE_OPS = 12


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds, "bytes" | "operations")."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def dense_stages(stage_first: np.ndarray) -> int:
    """How many leading stages form the dense phase."""
    counts = np.diff(stage_first)
    cum = np.cumsum(counts)
    return max(1, int(np.searchsorted(cum, DENSE_MAX_TREES, side="right")))


def _node_ops(n_rects: int) -> int:
    return 4 * n_rects + (n_rects - 1) + 2


def stage_ops(cascade, n_stages: int) -> list[int]:
    """Operations of each of the first `n_stages` stages for one window
    that enters it."""
    n_rects = (cascade.weights != 0).sum(1)
    out = []
    for s in range(n_stages):
        ops = 1
        for t in range(cascade.stage_first[s], cascade.stage_first[s + 1]):
            f0, fl, fr = cascade.tree_feat[t]
            thr = cascade.tree_thr[t]
            child = max(_node_ops(n_rects[f]) if np.isfinite(th) else 0
                        for f, th in ((fl, thr[1]), (fr, thr[2])))
            ops += _node_ops(n_rects[f0]) + child + 1
        out.append(ops)
    return out


def dense_ops(cascade, exits: list[list[int]]) -> int:
    """Operations the windows need: `exits` per level as from
    ``reference.cascade.Detector.stage_exits`` (windows failing the
    variance test, leaving at each dense stage, passing them all)."""
    n = len(exits[0]) - 2
    per_stage = stage_ops(cascade, n)
    total = 0
    for ex in exits:
        ex = np.asarray(ex, np.int64)
        total += VARIANCE_OPS * int(ex.sum())
        entering = np.cumsum(ex[1:][::-1])[::-1]      # entering stage k
        total += int(sum(int(entering[k]) * per_stage[k] for k in range(n)))
    return total


def dense_bytes(levels, image_bytes: int, n_frames: int) -> int:
    """Bytes: `image_bytes` read per frame, 5 B written per window."""
    windows = sum(l.nx * l.ny for l in levels)
    return n_frames * (image_bytes + 5 * windows)


def dense_share(ctx: dict, cascades: list[str], size: tuple[int, int],
                factor: float, min_size, input_is_work: bool,
                kernels: tuple[str, ...]) -> float | None:
    """Roofline share (%) of the dense phase of `cascades` at work size
    `size` over the traced calls (``ctx["traced_streams"]``: stream →
    calls; a call takes the stream's clip ``ctx["pool"][stream]``): the
    bound for the work these frames need, over the summed device time of
    `kernels`. None where the trace holds no such kernel."""
    import os

    import torch

    from ..reference import cascade as C

    measured_us = ctx["trace"].kernel_us(kernels)
    if measured_us <= 0 or not ctx.get("traced_streams"):
        return None
    n_bytes = n_ops = 0
    for name in cascades:
        casc = C.load_cascade(os.path.join(ctx["cascade_dir"], name))
        det = C.Detector(casc, size, factor, min_size, device=ctx["device"])
        n_dense = dense_stages(casc.stage_first)
        image = (size[0] * size[1] if input_is_work
                 else sum(l.sw * l.sh for l in det.levels))
        for s, calls in ctx["traced_streams"].items():
            clip = ctx["pool"][s]
            g = torch.from_numpy(clip).to(ctx["device"])
            work = C.equalize(C.resize_exact(g, *size))
            exits = det.stage_exits(work, n_dense)
            n_ops += calls * dense_ops(casc, exits)
            n_bytes += calls * dense_bytes(det.levels, image, len(clip))
    t, _ = bound_s(n_bytes, n_ops)
    return 100.0 * t / (measured_us * 1e-6)
