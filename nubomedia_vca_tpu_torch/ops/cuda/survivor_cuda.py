"""Survivor stages of a tilted cascade: the stages of one block for
the compacted survivors of one pyramid level, read from the level's sum
and tilted tables in place, in ``csrc/survivor_eval.cu``.

Replaces no TPU kernel: the JAX engine's survivor stages are XLA gathers
and dots (``nubomedia_vca_tpu/cascade/engine.py``, ``_level_post``). The
port did the same until this kernel: it gathered each survivor slot's
whole (h0+1)x(w0+1) patch of both tables, cast it to float64 and
multiplied it by dense [patch, features] matrices, about 120 times the
arithmetic that a feature's 7 to 12 corners need.

Arithmetic, the same in the kernel and in the plain version:

* a rect sum is its + - - + 4-corner sum on the absolute table (uint32
  wraparound, read as int32); a feature is the sum of its rects' sums
  times their integer weights, in exact int32 arithmetic (``SurvivorBlock``
  checks that the weights are integers and that no sum can leave int32),
  rounded once to float32, round to nearest;
* times the window's variance normalization ``vnf`` (float32), ``<``
  thresholds and leaf selects; a child whose threshold is +inf (a leaf of
  a 2-split tree) selects its first leaf whatever its feature;
* stage sums in float32 in weak-tree order; a slot passes when it is
  alive and every stage sum is >= its threshold.

This is the value of the patch arithmetic it replaces: inside every
+ - - + rect the row and column corrections of the window-relative patch
cancel, so the float64 product held the same exact integer, and rounded
it to the same float32.

``SurvivorBlock`` holds one block of a cascade for no level in particular;
``SurvivorPlan`` is that block at one level, with the corner offsets
multiplied by the level's row stride and packed into the int32 records
that the kernel stages in shared memory. ``survivor_eval`` runs the plain
version (``survivor_eval_reference``) for CPU tensors and launches the
kernel for CUDA tensors (counted in ``survivor_eval.launches`` and, while
tracing, in ``vca.engine.survivor_kernel_launches``), or raises; it never
falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...cascade.pyramid import LevelSpec
from ...utils.tracing import count
from . import _build
from .dense_cuda import MAX_GRID_Y, MAX_RECTS, MAX_SMEM_BYTES, device_index

# int32 words of a feature record (kFeatWords in csrc/survivor_eval.cu):
# rects, table (0 sum, 1 tilted), 4 corner offsets and a weight per rect
FEAT_WORDS = 2 + 5 * MAX_RECTS
# a weak tree's record (kTreeWords): root, left and right feature ids (-1
# for a leaf child), then float thr0, thrL, thrR, leafL0, leafL1, leafR0,
# leafR1
TREE_WORDS = 3 + 7
INT32_LIMIT = 2 ** 31


@dataclasses.dataclass(frozen=True)
class SurvivorBlock:
    """One block of a tilted cascade's stages as the survivor kernel reads
    it: its features' rects and its weak trees, for no level in
    particular. Feature ids are block-local."""

    n_rects: np.ndarray    # [F] int32
    tilted: np.ndarray     # [F] int32: 1 for rects on the tilted table
    dy: np.ndarray         # [F, MAX_RECTS, 4] int32 corner rows in the window
    dx: np.ndarray         # [F, MAX_RECTS, 4] int32 corner columns
    weight: np.ndarray     # [F, MAX_RECTS] int32 (0 past n_rects)
    feat: np.ndarray       # [W, 3] int32 root, left, right (-1: leaf child)
    thr: np.ndarray        # [W, 3] float32 thr0, thrL, thrR
    leaves: np.ndarray     # [W, 4] float32 leafL0, leafL1, leafR0, leafR1
    stage_lo: np.ndarray   # [S + 1] int32: trees of stage s are lo[s]:lo[s+1]
    stage_thr: np.ndarray  # [S] float32

    @classmethod
    def make(cls, feat_rects, feat_ids, feat0, featL, featR, thr0, thrL,
             thrR, leavesL, leavesR, tree_stage, stage_thr,
             window: tuple[int, int]) -> "SurvivorBlock":
        """From the engine's per-feature rects (``(table, corners,
        weight)``, all on one table, corners ``(dy, dx, sign)`` in + - - +
        order), the block's features ``feat_ids`` (global ids, in block
        order), its trees (block-local feature ids) and the stage of each
        tree. Raises ValueError for a weight that is not an integer, or for
        a feature whose sum could leave int32 on a window of ``window``
        (w0, h0) pixels of at most 255."""
        F = len(feat_ids)
        n_rects = np.zeros(F, np.int32)
        tilted = np.zeros(F, np.int32)
        dy = np.zeros((F, MAX_RECTS, 4), np.int32)
        dx = np.zeros((F, MAX_RECTS, 4), np.int32)
        weight = np.zeros((F, MAX_RECTS), np.int32)
        most = 255 * window[0] * window[1]  # largest sum of any rect
        for i, f in enumerate(feat_ids):
            rects = feat_rects[int(f)]
            n_rects[i] = len(rects)
            tilted[i] = rects[0][0] == "tilt"
            for r, (_, corners, wgt) in enumerate(rects):
                if wgt != int(wgt):
                    raise ValueError(
                        f"feature {f}: rect weight {wgt} is not an integer "
                        "(the survivor stages sum features exactly in int32)")
                dy[i, r] = [c[0] for c in corners]
                dx[i, r] = [c[1] for c in corners]
                weight[i, r] = int(wgt)
            if int(np.abs(weight[i]).sum()) * most >= INT32_LIMIT:
                raise ValueError(f"feature {f}: its sum can leave int32")
        thr = np.stack([thr0, thrL, thrR], 1).astype(np.float32)
        feat = np.stack([feat0, featL, featR], 1).astype(np.int32)
        feat[:, 1:][np.isposinf(thr[:, 1:])] = -1
        stage = np.asarray(tree_stage)      # in stage order
        first = int(stage[0])
        stage_lo = np.searchsorted(
            stage, np.arange(first, first + len(stage_thr) + 1)).astype(
                np.int32)
        return cls(n_rects, tilted, dy, dx, weight, feat, thr,
                   np.concatenate([leavesL, leavesR], 1).astype(np.float32),
                   stage_lo, np.asarray(stage_thr, np.float32))


@dataclasses.dataclass(frozen=True)
class SurvivorPlan:
    """One block at one level: the kernel's records, with corner offsets
    for the level's tables (row stride ``sw + 1``), and the plain
    version's tables, each copied to a device once."""

    level: LevelSpec
    block: SurvivorBlock
    records: np.ndarray     # int32: features, trees, stage_lo, stage_thr
    smem_bytes: int
    _device: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @classmethod
    def make(cls, level: LevelSpec, block: SurvivorBlock,
             max_smem: int = MAX_SMEM_BYTES) -> "SurvivorPlan":
        """Raises ValueError when the records do not fit `max_smem` bytes
        of shared memory."""
        F, W = len(block.n_rects), len(block.feat)
        offs = block.dy * (level.sw + 1) + block.dx
        feats = np.concatenate(
            [block.n_rects[:, None], block.tilted[:, None],
             offs.reshape(F, 4 * MAX_RECTS), block.weight], 1)
        trees = np.concatenate(
            [block.feat, np.concatenate([block.thr, block.leaves],
                                        1).view(np.int32)], 1)
        records = np.concatenate(
            [feats.reshape(-1), trees.reshape(-1), block.stage_lo,
             block.stage_thr.view(np.int32)]).astype(np.int32)
        assert feats.shape[1] == FEAT_WORDS and trees.shape[1] == TREE_WORDS
        smem = 4 * len(records)
        if smem > max_smem:
            raise ValueError(
                f"survivor records of {F} features and {W} weak trees need "
                f"{smem} B > {max_smem} B of shared memory")
        return cls(level, block, records, smem)

    @property
    def n_stages(self) -> int:
        return len(self.block.stage_thr)

    def device_records(self, device: torch.device) -> torch.Tensor:
        """The records on `device`, copied once."""
        recs = self._device.get(device)
        if recs is None:
            recs = torch.from_numpy(self.records).to(device)
            self._device[device] = recs
        return recs

    def reference_tables(self, device: torch.device) -> dict:
        """The plain version's tables on `device`, made once: per table
        (sum, tilted) the rects' corner offsets [R, 4], weights [R] and
        features [R]; the trees' feature ids (leaf children as 0),
        thresholds and leaves; each stage's trees [S, M] (M the most trees
        of a stage, padded with -1) and the stage thresholds."""
        key = ("reference", device)
        tabs = self._device.get(key)
        if tabs is None:
            b = self.block
            offs = b.dy * (self.level.sw + 1) + b.dx
            rects = []
            for t in (0, 1):
                f, r = np.nonzero((b.tilted[:, None] == t)
                                  & (np.arange(MAX_RECTS)
                                     < b.n_rects[:, None]))
                rects.append((offs[f, r].astype(np.int64),
                              b.weight[f, r].astype(np.int64),
                              f.astype(np.int64)))
            sizes = np.diff(b.stage_lo)
            stages = np.full((len(sizes), max(int(sizes.max(initial=0)), 1)),
                             -1, np.int64)
            for s, (lo, n) in enumerate(zip(b.stage_lo, sizes)):
                stages[s, :n] = np.arange(lo, lo + n)
            on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            tabs = dict(
                rects=[tuple(on(a) for a in r) for r in rects],
                feat=on(np.maximum(b.feat, 0).astype(np.int64)),
                thr=on(b.thr), leaves=on(b.leaves), stages=on(stages),
                stage_thr=on(b.stage_thr))
            self._device[key] = tabs
        return tabs


# ------------------------------------------------------------ plain version
# survivors whose corners the plain version gathers at once
_CHUNK_CORNERS = 1 << 22


def survivor_eval_reference(ii, iit, vnf, win_ids, alive,
                            plan: SurvivorPlan) -> torch.Tensor:
    """Plain PyTorch version (see the module docstring) → passed [B, k]
    bool: alive and through every stage of the block. Only alive slots are
    evaluated."""
    _check(ii, iit, vnf, win_ids, alive, plan)
    l, b = plan.level, plan.block
    B, k = win_ids.shape
    w1 = l.sw + 1
    passed = torch.zeros((B, k), dtype=torch.bool, device=alive.device)
    fr, slot = alive.nonzero(as_tuple=True)
    if fr.numel() == 0:
        return passed
    win = win_ids[fr, slot]
    origin = (fr * ((l.sh + 1) * w1) + (win // l.nx) * (l.ystep * w1)
              + (win % l.nx) * l.ystep)
    v = vnf.reshape(B, -1)[fr, win]
    tabs = plan.reference_tables(alive.device)
    n_corners = max(4 * sum(len(w) for _, w, _ in tabs["rects"]), 1)
    chunk = max(1, _CHUNK_CORNERS // n_corners)
    feats = torch.zeros((len(fr), len(b.n_rects)), dtype=torch.int32,
                        device=alive.device)
    for table, (offs, wgt, owner) in zip((ii, iit), tabs["rects"]):
        if not len(wgt):
            continue
        flat = table.reshape(-1)
        for c0 in range(0, len(fr), chunk):
            c = flat[origin[c0:c0 + chunk, None, None] + offs]  # [n, R, 4]
            sums = c[..., 0] - c[..., 1] - c[..., 2] + c[..., 3]
            feats[c0:c0 + chunk].index_add_(
                1, owner, (sums.long() * wgt).int())
    vals = feats.to(torch.float32) * v[:, None]
    fid, thr, leaves = tabs["feat"], tabs["thr"], tabs["leaves"]
    f0, fL, fR = (vals[:, fid[:, j]] for j in range(3))
    lv = torch.where(fL < thr[:, 1], leaves[:, 0], leaves[:, 1])
    rv = torch.where(fR < thr[:, 2], leaves[:, 2], leaves[:, 3])
    wout = torch.where(f0 < thr[:, 0], lv, rv)
    wpad = torch.cat([wout, torch.zeros_like(wout[:, :1])],
                     1)[:, tabs["stages"]]
    ssum = torch.zeros_like(wpad[..., 0])
    for m in range(wpad.shape[2]):      # weak-tree order, padded with 0.0
        ssum = ssum + wpad[..., m]
    passed[fr, slot] = (ssum >= tabs["stage_thr"]).all(dim=1)
    return passed


# ------------------------------------------------------------------ kernel
def _check(ii, iit, vnf, win_ids, alive, plan: SurvivorPlan) -> None:
    l = plan.level
    B, dev = win_ids.shape[0], win_ids.device
    for t, what in ((ii, "sum"), (iit, "tilted")):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B, l.sh + 1, l.sw + 1)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{what} table must be contiguous [B, "
                             f"{l.sh + 1}, {l.sw + 1}] int32 beside the slots")
    if (vnf.dtype != torch.float32 or vnf.numel() != B * l.ny * l.nx
            or not vnf.is_contiguous() or vnf.device != dev):
        raise ValueError(f"vnf must be contiguous float32 of [B, {l.ny}, "
                         f"{l.nx}] beside the slots")
    if win_ids.dtype != torch.int64 or win_ids.ndim != 2:
        raise TypeError("window ids must be [B, k] int64")
    if (alive.dtype != torch.bool or alive.shape != win_ids.shape
            or alive.device != dev):
        raise ValueError("alive must be [B, k] bool beside the window ids")
    if not (win_ids.is_contiguous() and alive.is_contiguous()):
        raise ValueError("window ids and alive must be contiguous")


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("survivor_eval")
    lib.survivor_eval_launch.argtypes = [
        _I, _P,                      # device, stream
        _P, _P, _P,                  # ii, iit, vnf
        _P, _P,                      # win_ids, alive
        _I, _I,                      # B, k
        _I, _I, _I, _I, _I,          # sh, sw, step, nx, ny
        _P, _I, _I, _I,              # records, n_feat, n_trees, n_stages
        _I,                          # smem
        _P,                          # passed_out
    ]
    lib.survivor_eval_launch.restype = ctypes.c_int
    lib.survivor_eval_init.argtypes = [_I, _I]   # device, max smem
    lib.survivor_eval_init.restype = ctypes.c_int
    lib.survivor_eval_error_string.argtypes = [ctypes.c_int]
    lib.survivor_eval_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _ready(device: int) -> ctypes.CDLL:
    """The library, with the kernel's shared memory limit raised to
    ``MAX_SMEM_BYTES`` on `device` (once per device, not per launch)."""
    lib = _library()
    rc = lib.survivor_eval_init(device, MAX_SMEM_BYTES)
    if rc != 0:
        msg = lib.survivor_eval_error_string(rc).decode()
        raise RuntimeError(f"survivor_eval set-up failed: {msg} ({rc})")
    return lib


def load(device: torch.device) -> None:
    """Build and load the kernel's library for `device` now (an engine
    does so when it is built, so that no call builds it)."""
    _ready(device_index(device))


def survivor_eval(ii, iit, vnf, win_ids, alive,
                  plan: SurvivorPlan) -> torch.Tensor:
    """Sum and tilted tables ii, iit [B, sh+1, sw+1] int32, the dense
    phase's vnf [B, ny, nx] float32, the compacted survivor slots' window
    ids [B, k] int64 and alive flags [B, k] bool → passed [B, k] bool:
    alive and through every stage of ``plan``'s block. A CUDA tensor
    launches the kernel or raises; a CPU tensor runs the plain version."""
    if win_ids.device.type == "cpu":
        return survivor_eval_reference(ii, iit, vnf, win_ids, alive, plan)
    if win_ids.device.type != "cuda":
        raise ValueError(f"no survivor kernel for {win_ids.device}")
    _check(ii, iit, vnf, win_ids, alive, plan)
    l, b = plan.level, plan.block
    B, k = win_ids.shape
    if not 1 <= B <= MAX_GRID_Y:
        raise ValueError(f"1 to {MAX_GRID_Y} frames per launch, got {B}")
    dev = win_ids.device
    passed = torch.empty((B, k), dtype=torch.bool, device=dev)
    if k == 0:
        return passed
    idx = device_index(dev)
    lib = _ready(idx)
    rc = lib.survivor_eval_launch(
        idx, torch.cuda.current_stream(dev).cuda_stream,
        ii.data_ptr(), iit.data_ptr(), vnf.data_ptr(), win_ids.data_ptr(),
        alive.data_ptr(), B, k, l.sh, l.sw, l.ystep, l.nx, l.ny,
        plan.device_records(dev).data_ptr(), len(b.n_rects), len(b.feat),
        plan.n_stages, plan.smem_bytes, passed.data_ptr())
    if rc != 0:
        msg = lib.survivor_eval_error_string(rc).decode()
        raise RuntimeError(f"survivor_eval kernel launch failed: {msg} ({rc})")
    survivor_eval.launches += 1
    count("vca.engine.survivor_kernel_launches")
    return passed


survivor_eval.launches = 0
