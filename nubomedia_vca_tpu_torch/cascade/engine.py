"""Multiscale Haar-cascade detection engine in PyTorch — the port of
``nubomedia_vca_tpu/cascade/engine.py`` (the replacement for
``cv::CascadeClassifier::detectMultiScale``).

Per batch of work images:

* **Dense phase**: for every pyramid level, the level image, integral
  tables, variance normalization and the first few stages (the dense
  block) on the level's ystep-strided window grid. Each level takes one of
  two routes, chosen from the cascade and the level's geometry alone
  (``_route``), so the CPU runs the same control flow as the card, each
  kernel through its plain PyTorch version:

  - ``pyramid``: every level of a non-tilted cascade, all in one launch of
    ``ops/cuda/dense_cuda.pyramid_dense_phase`` (which also makes the level
    images), which cuts each level into bands of window rows that fit one
    block's shared memory;
  - ``tilted``: every level of a tilted cascade, resized here, then
    ``dense_level_cuda.dense_level_tilted`` (the tables in device memory,
    then a tiled evaluation whose shared memory a tile sets, not the
    level), which also emits the sum and tilted tables.
* **Compaction**: surviving windows are compacted to a static per-level
  capacity with ``torch.topk`` (earliest index first); a per-frame overflow
  flag reports survivors beyond capacity, and ``widened()`` gives the
  engine at twice its capacities for running such frames again.
* **Survivor stages**, the stages after the dense block, in the blocks of
  ``BLOCK_PLAN``, re-compacted before each; each route builds and runs its
  own form of the blocks. ``tilted`` (``_table_stages``): a block is one
  launch of ``ops/cuda/survivor_cuda.survivor_eval``, which reads each
  survivor's feature corners from the dense phase's tables in place.
  ``pyramid`` (``_matmul_stages``): each survivor's sum-table patch is
  rebuilt once from the level image as the patch-local integral; a block's
  feature values are one patch x feature-matrix matmul, weak trees are
  selects and stage sums a second small matmul. A cascade with no stage
  past the dense block emits the dense survivors directly.
* **Grouping** (``group_device``): exact minNeighbors grouping on the
  device, only [B, 64] grouped boxes leave it.

Numerics match the JAX package exactly: integer where integer (tables, rect
sums, resize), and the same float32 operations elsewhere. The float32
matmuls must not round through TF32, so the engine refuses to run when
``torch.backends.cuda.matmul.allow_tf32`` is set or the float32 matmul
precision is not "highest" (both are PyTorch's defaults); it changes no
global setting itself. A feature matmul of the ``pyramid`` route whose
partial sums can reach 2^24 (a cascade with windows as large as the
smile's 36x18, were it not tilted) runs in float64, where every partial
sum is an exact integer, and is rounded once to float32, so its result
does not depend on the summation order of the device's BLAS. The survivor
kernel of the ``tilted`` route sums each feature exactly in int32 and
rounds it once, the same value.

The TPU compile machinery of the JAX engine (per-level programs, program
grouping, warm-up, recovery tiers) has no counterpart: PyTorch runs
eagerly. Engines run on the card unless the caller asks for another
device; a level that no route takes raises, and nothing falls back.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda import survivor_cuda
from ..ops.cuda.dense_cuda import (MAX_SMEM_BYTES, DenseTables,
                                   PyramidDensePlan, pyramid_dense_phase,
                                   pyramid_fits)
from ..ops.cuda.dense_level_cuda import (DenseLevelPlan, dense_level_tilted,
                                         tilted_fits)
from ..ops.cuda.survivor_cuda import SurvivorBlock, SurvivorPlan
from ..ops.grouping import group_rectangles_torch
from ..ops.resize import resize_linear_exact
from ..utils.tracing import trace
from .pyramid import LevelSpec, compute_levels
from .xml_loader import HaarCascade


def _sum_corner_offsets(x, y, w, h):
    """Axis-aligned rect → 4 (dy, dx, sign) corners on the sum table."""
    return [(y, x, 1), (y, x + w, -1), (y + h, x, -1), (y + h, x + w, 1)]


def _tilt_corner_offsets(x, y, w, h):
    """Tilted rect → 4 (dy, dx, sign) corners on the tilted table:
    sum = T[y,x] - T[y+w,x+w] - T[y+h,x-h] + T[y+w+h,x+w-h]."""
    return [(y, x, 1), (y + w, x + w, -1), (y + h, x - h, -1),
            (y + w + h, x + w - h, 1)]


@dataclasses.dataclass
class _Block:
    """One block of stages after the dense block, as both routes plan it:
    its features (cascade ids), trees, stages and capacity."""

    feats: list[int]
    feat0: np.ndarray          # [Wb] i32 (block-local feature ids)
    thr0: np.ndarray
    featL: np.ndarray
    thrL: np.ndarray
    leavesL: np.ndarray        # [Wb, 2]
    featR: np.ndarray
    thrR: np.ndarray
    leavesR: np.ndarray
    tree_stage: np.ndarray     # [Wb] stage of each tree, from 0
    stage_thr: np.ndarray      # [Sb] f32
    cap_frac: float            # capacity fraction of level windows

    def trees(self) -> dict[str, np.ndarray]:
        """The trees and stage thresholds by field name."""
        return {f: getattr(self, f) for f in (
            "feat0", "thr0", "featL", "thrL", "leavesL", "featR", "thrR",
            "leavesR", "stage_thr")}


@dataclasses.dataclass
class _MatmulBlock(_Block):
    """A block in the ``pyramid`` route's form (the JAX engine's block):
    patches x ``w_sum`` are the features, leaves x ``stage_onehot`` the
    stage sums."""

    w_sum: np.ndarray          # [PP, Fb] f32
    stage_onehot: np.ndarray   # [Wb, Sb] f32

    def to(self, device: torch.device,
           patch_dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """The tables the matmuls read as tensors on `device`, the feature
        matrix in the engine's patch dtype."""
        out = {"w_sum": torch.from_numpy(self.w_sum).to(device, patch_dtype),
               "stage_onehot": torch.from_numpy(self.stage_onehot).to(device)}
        for name, v in self.trees().items():
            t = torch.from_numpy(v)
            out[name] = (t.long() if v.dtype.kind == "i" else t).to(device)
        return out


def _check_true_f32_matmul(who: str = "CascadeEngine") -> None:
    """Raise unless float32 matmuls run in full float32, as the JAX
    package pins them (``Precision.HIGHEST``): the engine's _block_eval
    loses parity under TF32 rounding (patch values up to ~1e5), and the
    CNN's float32 head is held to the same rule."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{who} needs torch.backends.cuda.matmul.allow_tf32 == False "
            "(its float32 matmuls must not round through TF32)")
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            f"{who} needs torch.get_float32_matmul_precision() == "
            f"'highest', got {prec!r}")


def _resolve_device(device: str | torch.device) -> torch.device:
    """`device` with its index made explicit; raises for a CUDA device on a
    host without one (never runs a CUDA request on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class CascadeEngine:
    """Batched multiscale detector for one cascade at one static image size,
    on one device.

    Produces raw candidate windows (pre-grouping) with OpenCV-parity
    coordinates; ``detect()`` adds exact minNeighbors grouping.
    """

    RAW_GROUP_CAP = 256   # accepted windows entering grouping (pre-compact)
    OUT_GROUP_CAP = 64    # grouped detections leaving the device
    MAX_CAPACITY = 32768  # survivor slots per level and block
    DENSE_MAX_WEAK = 48   # the dense (kernel) block: the first stages whose
                          # cumulative weak-tree count stays <= this (>= 1)
    # the blocks after the dense block: (stages, capacity as a fraction of
    # the level's windows); None = every remaining stage. For frontalface_alt:
    # dense 3 stages → (5 stages, 45%) → (14 stages, 8%)
    BLOCK_PLAN = ((5, 0.45), (None, 0.08))
    F32_EXACT = 2 ** 24   # integers float32 holds exactly

    def __init__(
        self,
        cascade: HaarCascade,
        image_size: tuple[int, int],           # (W, H)
        scale_factor: float = 1.25,
        min_size: tuple[int, int] = (0, 0),
        max_size: tuple[int, int] = (0, 0),
        device: str | torch.device = "cuda",
    ):
        _check_true_f32_matmul()
        self.device = _resolve_device(device)
        self.cascade = cascade
        self.image_w, self.image_h = image_size
        self.scale_factor = scale_factor
        self.levels: list[LevelSpec] = compute_levels(
            self.image_w, self.image_h, cascade.window_w, cascade.window_h,
            scale_factor, min_size, max_size,
        )
        if not self.levels:
            raise ValueError("image smaller than cascade window")

        cum = np.cumsum(cascade.stage_weak_counts())
        self.n_dense_stages = min(cascade.n_stages, max(1, int(
            np.searchsorted(cum, self.DENSE_MAX_WEAK, side="right"))))
        self._build_tables()

        self._tables = DenseTables(
            (cascade.window_w, cascade.window_h), self._feat_rects,
            self._dense, self.n_dense_stages)
        self.routes = [self._route(l) for l in self.levels]
        self._pyramid_lis = [li for li, r in enumerate(self.routes)
                             if r == "pyramid"]
        self._plan = (PyramidDensePlan(
            (self.image_w, self.image_h),
            [self.levels[li] for li in self._pyramid_lis], self._tables)
            if self._pyramid_lis else None)
        self._level_plans = {
            li: DenseLevelPlan.make(self.levels[li], self._tables)
            for li, r in enumerate(self.routes) if r == "tilted"}

        dev = self.device
        if self._pyramid_lis:
            # the pyramid route's survivor stages: patch x feature matmuls,
            # on patches gathered at each window's pixel offsets
            self._blocks = [self._matmul_block(blk) for blk in self._blocks]
            self._patch_dtype = (torch.float64 if self._needs_f64()
                                 else torch.float32)
            self._blocks_dev = [blk.to(dev, self._patch_dtype)
                                for blk in self._blocks]
            self._img_poff_dev = {
                li: torch.from_numpy((
                    np.arange(cascade.window_h)[:, None] * self.levels[li].sw
                    + np.arange(cascade.window_w)).reshape(-1)).to(dev)
                for li in self._pyramid_lis}
        # the tilted route's: one survivor-kernel plan per level and block
        survivor = ([SurvivorBlock.make(
            self._feat_rects, blk.feats, tree_stage=blk.tree_stage,
            window=(cascade.window_w, cascade.window_h), **blk.trees())
            for blk in self._blocks] if self._level_plans else [])
        self._survivor_plans = {
            li: [SurvivorPlan.make(self.levels[li], sb) for sb in survivor]
            for li in self._level_plans}
        # each level's raw box by window id: (x, y) in original pixels,
        # the level's window size
        self._boxes_dev = [
            torch.from_numpy(np.stack(np.broadcast_arrays(
                mx[None, :], my[:, None], l.out_w, l.out_h),
                -1).reshape(-1, 4).astype(np.int32)).to(dev)
            for l, (mx, my) in zip(self.levels, self._maps)]
        if dev.type == "cuda" and survivor:
            survivor_cuda.load(dev)
            for plans in self._survivor_plans.values():
                for plan in plans:
                    plan.device_records(dev)

    # ------------------------------------------------------------------ prep
    def _route(self, l: LevelSpec) -> str:
        """The dense-phase route of level `l`, from its geometry alone (see
        the module docstring)."""
        if self._uses_tilt:
            if tilted_fits(l, self._tables):
                return "tilted"
            raise NotImplementedError(
                f"level {l.sw}x{l.sh}: no dense kernel takes it (the tilted "
                "kernels need a tile of windows and the tilted table's rows "
                f"in {MAX_SMEM_BYTES} B of shared memory)")
        if pyramid_fits(l, self.cascade.window_h):
            return "pyramid"
        raise NotImplementedError(
            f"level {l.sw}x{l.sh}: no dense kernel takes it (the pyramid "
            "kernel needs both tables of a band of "
            f"{self.cascade.window_h} rows in {MAX_SMEM_BYTES} B of shared "
            "memory)")

    def _needs_f64(self) -> bool:
        """Whether a feature matmul's partial sums can reach 2^24: when
        sum(|weight| * largest patch entry) of a feature does (patch entry
        (dy, dx) is at most 255*dy*dx)."""
        most = 255.0 * np.outer(np.arange(self._ph),
                                np.arange(self._pw)).reshape(-1)
        return any(
            float((np.abs(blk.w_sum) * most[:, None]).sum(0).max())
            >= self.F32_EXACT
            for blk in self._blocks)

    def _build_tables(self) -> None:
        c = self.cascade
        self._pw, self._ph = c.window_w + 1, c.window_h + 1

        # per-feature corner decomposition
        self._feat_rects = []
        for f in range(c.n_features):
            rects = []
            for r in range(c.rects.shape[1]):
                wgt = float(c.rect_weights[f, r])
                if wgt == 0.0:
                    continue
                x, y, w, h = (int(v) for v in c.rects[f, r])
                corners = (_tilt_corner_offsets(x, y, w, h) if c.tilted[f]
                           else _sum_corner_offsets(x, y, w, h))
                rects.append(("tilt" if c.tilted[f] else "sum", corners, wgt))
            self._feat_rects.append(rects)
        self._uses_tilt = bool(c.has_tilted)

        counts = c.stage_weak_counts()
        cum = np.concatenate([[0], np.cumsum(counts)])

        # dense block
        nd = self.n_dense_stages
        split = int(cum[nd])
        self._dense = dict(
            feat0=c.feat0[:split], thr0=c.thr0[:split],
            featL=c.featL[:split], thrL=c.thrL[:split], leavesL=c.leavesL[:split],
            featR=c.featR[:split], thrR=c.thrR[:split], leavesR=c.leavesR[:split],
            stage=c.weak_stage[:split],
            stage_thr=c.stage_thresholds[:nd],
        )

        # the blocks after the dense block
        self._blocks: list[_Block] = []
        s_lo = nd
        for n_stages, frac in self.BLOCK_PLAN:
            s_hi = (c.n_stages if n_stages is None
                    else min(s_lo + n_stages, c.n_stages))
            if s_hi <= s_lo:
                continue
            w_lo, w_hi = int(cum[s_lo]), int(cum[s_hi])
            self._blocks.append(self._make_block(w_lo, w_hi, s_lo, s_hi, frac))
            s_lo = s_hi

        self._set_capacities(1)

        # original-pixel coordinate maps
        self._maps = []
        for l in self.levels:
            xs = (np.arange(l.nx) * l.ystep).astype(np.float64)
            ys = (np.arange(l.ny) * l.ystep).astype(np.float64)
            self._maps.append((
                np.rint(xs * l.factor).astype(np.int32),
                np.rint(ys * l.factor).astype(np.int32),
            ))

    def _set_capacities(self, scale: int) -> None:
        """Per-level survivor capacities of each block, and the raw
        candidates entering grouping, at `scale` times the plan's."""
        self.capacity_scale = scale
        self._level_caps: list[list[int]] = []
        for l in self.levels:
            caps = []
            prev = l.n_windows
            for blk in self._blocks:
                cap = int(min(prev, self.MAX_CAPACITY * scale,
                              max(64, int(np.ceil(
                                  l.n_windows * blk.cap_frac * scale)))))
                caps.append(cap)
                prev = cap
            self._level_caps.append(caps)
        self.total_capacity = sum(
            caps[-1] if caps else l.n_windows
            for caps, l in zip(self._level_caps, self.levels))
        self._wider = None

    def widened(self) -> "CascadeEngine":
        """This engine at twice its capacities, for frames whose overflow
        flag it set: the same tables and kernels, built once and kept.
        Doubling ends: at full capacity (every window of every level, and
        every accepted window into grouping) no flag can be set."""
        if self._wider is None:
            wide = copy.copy(self)
            wide._set_capacities(2 * self.capacity_scale)
            self._wider = wide
        return self._wider

    def _make_block(self, w_lo, w_hi, s_lo, s_hi, frac) -> _Block:
        c = self.cascade
        feats = sorted(
            {int(f) for f in np.concatenate(
                [c.feat0[w_lo:w_hi], c.featL[w_lo:w_hi], c.featR[w_lo:w_hi]])}
        )
        remap = {f: i for i, f in enumerate(feats)}
        rm = np.vectorize(lambda f: remap[int(f)], otypes=[np.int32])
        return _Block(
            feats=feats,
            feat0=rm(c.feat0[w_lo:w_hi]), thr0=c.thr0[w_lo:w_hi],
            featL=rm(c.featL[w_lo:w_hi]), thrL=c.thrL[w_lo:w_hi],
            leavesL=c.leavesL[w_lo:w_hi],
            featR=rm(c.featR[w_lo:w_hi]), thrR=c.thrR[w_lo:w_hi],
            leavesR=c.leavesR[w_lo:w_hi],
            tree_stage=c.weak_stage[w_lo:w_hi] - s_lo,
            stage_thr=c.stage_thresholds[s_lo:s_hi], cap_frac=frac)

    def _matmul_block(self, blk: _Block) -> _MatmulBlock:
        """`blk` in the pyramid route's form (a cascade with no tilted
        feature): each feature's weighted corners in its patch column."""
        w_sum = np.zeros((self._pw * self._ph, len(blk.feats)), np.float32)
        for i, f in enumerate(blk.feats):
            for _, corners, wgt in self._feat_rects[f]:
                for (dy, dx, s) in corners:
                    assert 0 <= dy < self._ph and 0 <= dx < self._pw
                    w_sum[dy * self._pw + dx, i] += s * wgt
        onehot = np.eye(len(blk.stage_thr), dtype=np.float32)[blk.tree_stage]
        return _MatmulBlock(**vars(blk), w_sum=w_sum, stage_onehot=onehot)

    # ------------------------------------------------------------- stages
    @staticmethod
    def _compact(alive: torch.Tensor, cap: int):
        """alive [B, N] bool → (sel [B, k] indices, sel_alive, count).

        Alive windows come first in ascending index order, then dead ones in
        ascending index order — the order the JAX engine's ``lax.top_k``
        over descending keys gives (it breaks ties toward the lower index);
        here the keys are made distinct, so the order is the same on every
        device."""
        B, N = alive.shape
        keys = (torch.arange(N, 0, -1, device=alive.device)
                + N * alive.to(torch.int64))
        k = min(cap, N)
        _, sel = torch.topk(keys, k, dim=1)
        sel_alive = alive.gather(1, sel)
        count = alive.sum(dim=1)
        return sel, sel_alive, count

    @staticmethod
    def _block_eval(blk: dict, patch, vnf_sel):
        """patch [B,C,PP] (sum-table patches, in the engine's patch dtype),
        vnf_sel [B,C] → pass [B,C]. The feature matmul is exact integer
        arithmetic (float32 where every partial sum stays below 2^24, else
        float64), so its summation order does not matter; the features are
        rounded once to float32. TF32 would round the patch values."""
        feats = torch.matmul(patch, blk["w_sum"])
        vals = feats.to(torch.float32) * vnf_sel[:, :, None]
        v0 = vals[..., blk["feat0"]]
        vL = vals[..., blk["featL"]]
        vR = vals[..., blk["featR"]]
        lv = torch.where(vL < blk["thrL"], blk["leavesL"][:, 0],
                         blk["leavesL"][:, 1])
        rv = torch.where(vR < blk["thrR"], blk["leavesR"][:, 0],
                         blk["leavesR"][:, 1])
        wout = torch.where(v0 < blk["thr0"], lv, rv)
        ssums = torch.matmul(wout, blk["stage_onehot"])
        return (ssums >= blk["stage_thr"]).all(dim=-1)

    def _level_post(self, li, src, vnf, alive):
        """Strided dense-grid maps of level `li` → (boxes [B,cap,4] i32,
        valid [B,cap], overflow [B]): compaction, then the blocks in the
        form of the level's route, re-compacting the survivors before each.
        `src` is what that form reads: the level image [B,sh,sw] u8
        (``pyramid``) or the sum and tilted tables [B,sh+1,sw+1]
        (``tilted``)."""
        with trace("vca.engine.survivor"):
            l, caps = self.levels[li], self._level_caps[li]
            B = alive.shape[0]
            cap = caps[0] if caps else min(
                l.n_windows, self.MAX_CAPACITY * self.capacity_scale)
            win_ids, sel_alive, count = self._compact(alive.reshape(B, -1),
                                                      cap)
            overflow = count > cap
            if self._blocks:
                stages = (self._matmul_stages
                          if self.routes[li] == "pyramid"
                          else self._table_stages)
                win_ids, sel_alive, overflow = stages(
                    li, src, vnf, win_ids, sel_alive, overflow)
            return self._boxes_dev[li][win_ids], sel_alive, overflow

    def _recompact(self, cap, alive, overflow, slots):
        """Before a block of capacity `cap`: the survivors `alive` [B,k]
        re-compacted to `cap` slots when that is fewer, and every per-slot
        tensor of `slots` ([B,k,...], window ids first) taken to the new
        slots → (alive, overflow, slots)."""
        if cap >= alive.shape[1]:
            return alive, overflow, slots
        sel, alive, count = self._compact(alive, cap)
        return alive, overflow | (count > cap), [
            t.gather(1, sel.reshape(*sel.shape, *[1] * (t.ndim - 2)).expand(
                *sel.shape, *t.shape[2:])) for t in slots]

    def _matmul_stages(self, li, img, vnf, win_ids, alive, overflow):
        """The ``pyramid`` route's blocks: each survivor's sum-table patch,
        the patch-local integral of its window in the level image `img`,
        gathered once and taken along on re-compaction; a block is one
        ``_block_eval``."""
        l = self.levels[li]
        B, k = win_ids.shape
        y, x = (win_ids // l.nx) * l.ystep, (win_ids % l.nx) * l.ystep
        idx = (y * l.sw + x)[:, :, None] + self._img_poff_dev[li]
        pimg = img.reshape(B, -1).gather(1, idx.reshape(B, -1)).reshape(
            B, k, self._ph - 1, self._pw - 1)
        local = torch.cumsum(
            torch.cumsum(pimg.to(torch.int32), dim=-1, dtype=torch.int32),
            dim=-2, dtype=torch.int32)
        # the slots list holds the only reference to each level's patches,
        # so that a re-compaction frees the ones it replaces
        slots = [win_ids, F.pad(local, (1, 0, 1, 0)).reshape(B, k, -1).to(
            self._patch_dtype), vnf.reshape(B, -1).gather(1, win_ids)]
        for cap, blk in zip(self._level_caps[li], self._blocks_dev):
            alive, overflow, slots = self._recompact(cap, alive, overflow,
                                                     slots)
            alive = alive & self._block_eval(blk, *slots[1:])
        return slots[0], alive, overflow

    def _table_stages(self, li, tables, vnf, win_ids, alive, overflow):
        """The ``tilted`` route's blocks: a block is one ``survivor_eval``
        on the level's sum and tilted tables."""
        for cap, plan in zip(self._level_caps[li], self._survivor_plans[li]):
            alive, overflow, (win_ids,) = self._recompact(cap, alive,
                                                          overflow, [win_ids])
            alive = survivor_cuda.survivor_eval(*tables, vnf, win_ids, alive,
                                                plan)
        return win_ids, alive, overflow

    def _dense_level(self, gray: torch.Tensor, li: int):
        """Tilted level `li` → ([ii, iit], vnf, alive)."""
        with trace("vca.engine.dense"):
            l = self.levels[li]
            same = (l.sw, l.sh) == (self.image_w, self.image_h)
            img = gray if same else resize_linear_exact(gray, (l.sw, l.sh))
            *tables, vnf, alive = dense_level_tilted(img,
                                                     self._level_plans[li])
            return tables, vnf, alive

    def _detect_impl(self, gray: torch.Tensor):
        """gray [B, H, W] uint8 → (boxes [B, TC, 4] i32, valid [B, TC] bool,
        overflow [B] bool)."""
        dense: dict[int, tuple] = {}
        if self._plan is not None:
            with trace("vca.engine.dense"):
                levels = pyramid_dense_phase(gray, self._plan)
            for li, (img_l, vnf, alive) in zip(self._pyramid_lis, levels):
                dense[li] = (gray if img_l is None else img_l, vnf, alive)
        out_boxes, out_valid = [], []
        overflow = torch.zeros((gray.shape[0],), dtype=torch.bool,
                               device=gray.device)
        for li in range(len(self.levels)):
            src, vnf, alive = (dense.pop(li, None)
                               or self._dense_level(gray, li))
            boxes, valid, ovf = self._level_post(li, src, vnf, alive.bool())
            out_boxes.append(boxes)
            out_valid.append(valid)
            overflow |= ovf
        return (torch.cat(out_boxes, dim=1), torch.cat(out_valid, dim=1),
                overflow)

    # ------------------------------------------------------------------- API
    def _as_batch(self, gray) -> torch.Tensor:
        """Frames on the engine's device as [B, H, W] uint8. Host arrays are
        copied to the engine's device; a tensor on another device raises."""
        if isinstance(gray, torch.Tensor):
            if gray.device != self.device:
                raise ValueError(
                    f"frames on {gray.device}, engine on {self.device}")
        else:
            gray = torch.from_numpy(np.ascontiguousarray(gray)).to(
                self.device)
        if gray.ndim == 2:
            gray = gray[None]
        if tuple(gray.shape[-2:]) != (self.image_h, self.image_w):
            raise ValueError(
                f"frame shape {tuple(gray.shape[-2:])} does not match engine "
                f"size ({self.image_h}, {self.image_w}); build a "
                "CascadeEngine for this resolution")
        return gray.contiguous()

    def detect_raw(self, gray):
        """gray [B,H,W] or [H,W] uint8 → (boxes, valid, overflow) on the
        engine's device."""
        return self._detect_impl(self._as_batch(gray))

    def _group_impl(self, boxes, valid, overflow, *, min_neighbors: int):
        """Device minNeighbors grouping on the raw-candidate output: compact
        accepted windows to RAW_GROUP_CAP, run the exact fixed-capacity
        groupRectangles, compact grouped classes to OUT_GROUP_CAP."""
        with trace("vca.engine.group"):
            cap = min(self.RAW_GROUP_CAP * self.capacity_scale,
                      valid.shape[1])
            sel, sel_alive, count = self._compact(valid, cap)
            overflow = overflow | (count > cap)
            cand = boxes.gather(1, sel[:, :, None].expand(-1, -1, 4))
            avg, gvalid, weights = group_rectangles_torch(
                cand, sel_alive, min_neighbors)
            k = min(self.OUT_GROUP_CAP, avg.shape[1])
            sel2, g_alive, _ = self._compact(gvalid, k)
            out = avg.gather(1, sel2[:, :, None].expand(-1, -1, 4))
            wts = weights.gather(1, sel2)
            return out, g_alive, wts, overflow

    def _compact_raw_impl(self, boxes, valid, overflow):
        with trace("vca.engine.group"):
            cap = min(self.RAW_GROUP_CAP * self.capacity_scale,
                      valid.shape[1])
            sel, sel_alive, count = self._compact(valid, cap)
            overflow = overflow | (count > cap)
            out = boxes.gather(1, sel[:, :, None].expand(-1, -1, 4))
            return out, sel_alive, overflow

    def compact_raw(self, raw):
        """(boxes, valid, overflow) → same, compacted to RAW_GROUP_CAP slots
        on the device, so ungrouped candidate transfers stay small."""
        return self._compact_raw_impl(*raw)

    def group_device(self, raw, min_neighbors: int):
        """(boxes, valid, overflow) from detect_raw → grouped device tensors
        (boxes [B,K,4], valid [B,K], weights [B,K], overflow [B])."""
        return self._group_impl(*raw, min_neighbors=min_neighbors)

    def detect_grouped(self, gray, min_neighbors: int = 3):
        """Whole device path: frames → grouped detections.
        Returns (boxes [B,K,4], valid [B,K], weights [B,K], overflow [B])."""
        return self.group_device(self.detect_raw(gray), min_neighbors)

    def detect(self, gray, min_neighbors: int = 3) -> list[np.ndarray]:
        """Full detectMultiScale parity: per-frame grouped [M,4] (x,y,w,h)
        as host arrays. min_neighbors == 0 skips grouping (OpenCV
        semantics)."""
        if min_neighbors == 0:
            return self.candidates(gray)
        out, g_alive, _, _ = self.detect_grouped(gray, min_neighbors)
        out, g_alive = out.cpu().numpy(), g_alive.cpu().numpy()
        return [out[b][g_alive[b]] for b in range(out.shape[0])]

    def candidates(self, gray) -> list[np.ndarray]:
        """Raw accepted windows per frame (pre-grouping), as host arrays."""
        boxes, valid, _ = self.detect_raw(gray)
        boxes, valid = boxes.cpu().numpy(), valid.cpu().numpy()
        return [boxes[b][valid[b]] for b in range(boxes.shape[0])]


@functools.lru_cache(maxsize=64)
def load_cascade(path: str) -> HaarCascade:
    from .xml_loader import load_cascade_xml
    return load_cascade_xml(path)


_ENGINE_CACHE: dict = {}


def get_engine(cascade_path: str, image_size: tuple[int, int],
               scale_factor: float = 1.25,
               min_size: tuple[int, int] = (0, 0),
               max_size: tuple[int, int] = (0, 0),
               device: str | torch.device = "cuda") -> CascadeEngine:
    """Process-wide engine cache, one engine per configuration and device.
    Engines are stateless after construction; models share them."""
    dev = _resolve_device(device)
    key = (os.path.abspath(cascade_path), tuple(image_size),
           float(scale_factor), tuple(min_size), tuple(max_size), str(dev))
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = CascadeEngine(load_cascade(cascade_path), image_size,
                            scale_factor, min_size=min_size,
                            max_size=max_size, device=dev)
        _ENGINE_CACHE[key] = eng
    return eng
