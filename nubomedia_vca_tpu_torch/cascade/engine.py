"""Multiscale Haar-cascade detection engine in PyTorch — the port of
``nubomedia_vca_tpu/cascade/engine.py`` (the replacement for
``cv::CascadeClassifier::detectMultiScale``).

Per batch of work images:

* **Dense phase** (``ops/cuda/dense_cuda.pyramid_dense_phase``): for every
  pyramid level, the level image, integral tables, variance normalization
  and the first few stages on the level's ystep-strided window grid. On a
  CUDA device this is one hand-written kernel launch for all levels; on the
  CPU its plain PyTorch version.
* **Compaction**: surviving windows are compacted to a static per-level
  capacity with ``torch.topk`` (earliest index first); a per-frame overflow
  flag reports survivors beyond capacity.
* **Matmul blocks**: for survivors the window's pixels are gathered from
  the level image and turned into the patch-local integral table; each
  block's feature values are one patch x feature-matrix float32 matmul,
  weak trees are selects and stage sums a second small matmul. Between
  blocks the survivor set is re-compacted.
* **Grouping** (``group_device``): exact minNeighbors grouping on the
  device, only [B, 64] grouped boxes leave it.

Numerics match the JAX package exactly: integer where integer (tables, rect
sums, resize), and the same float32 operations elsewhere. The float32
matmuls must not round through TF32, so the engine refuses to run when
``torch.backends.cuda.matmul.allow_tf32`` is set or the float32 matmul
precision is not "highest" (both are PyTorch's defaults); it changes no
global setting itself.

The TPU compile machinery of the JAX engine (per-level programs, program
grouping, warm-up, recovery tiers) has no counterpart: PyTorch runs
eagerly. Tilted cascades raise NotImplementedError, as do, on CUDA, levels
too large for the kernel's shared memory; both need TPU kernels still to
port, and no such case runs silently on another path.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.dense_cuda import PyramidDensePlan, pyramid_dense_phase
from ..ops.grouping import group_rectangles_torch
from .pyramid import LevelSpec, compute_levels
from .xml_loader import HaarCascade


def _sum_corner_offsets(x, y, w, h):
    """Axis-aligned rect → 4 (dy, dx, sign) corners on the sum table."""
    return [(y, x, 1), (y, x + w, -1), (y + h, x, -1), (y + h, x + w, 1)]


@dataclasses.dataclass
class _Block:
    """Host-precomputed tables for one matmul block of stages."""

    w_sum: np.ndarray          # [PP, Fb] f32
    feat0: np.ndarray         # [Wb] i32 (block-local feature ids)
    thr0: np.ndarray
    featL: np.ndarray
    thrL: np.ndarray
    leavesL: np.ndarray        # [Wb, 2]
    featR: np.ndarray
    thrR: np.ndarray
    leavesR: np.ndarray
    stage_onehot: np.ndarray   # [Wb, Sb] f32
    stage_thr: np.ndarray      # [Sb] f32
    cap_frac: float            # capacity fraction of level windows

    def to(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The evaluation tables as tensors on `device`."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                out[f.name] = (t.long() if v.dtype.kind == "i" else t).to(
                    device)
        return out


def _check_true_f32_matmul() -> None:
    """_block_eval needs float32 matmuls in full float32 (patch values up
    to ~1e5 lose parity under TF32 rounding)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "CascadeEngine needs torch.backends.cuda.matmul.allow_tf32 == "
            "False (TF32 rounding breaks exact cascade evaluation)")
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            "CascadeEngine needs torch.get_float32_matmul_precision() == "
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
    MAX_CAPACITY = 32768  # survivor slots per level and matmul block
    DENSE_MAX_WEAK = 48   # the dense (kernel) block: the first stages whose
                          # cumulative weak-tree count stays <= this (>= 1)
    # matmul blocks after the dense block: (stages, capacity as a fraction of
    # the level's windows); None = every remaining stage. For frontalface_alt:
    # dense 3 stages → (5 stages, 45%) → (14 stages, 8%)
    BLOCK_PLAN = ((5, 0.45), (None, 0.08))

    def __init__(
        self,
        cascade: HaarCascade,
        image_size: tuple[int, int],           # (W, H)
        scale_factor: float = 1.25,
        min_size: tuple[int, int] = (0, 0),
        max_size: tuple[int, int] = (0, 0),
        device: str | torch.device = "cpu",
    ):
        _check_true_f32_matmul()
        self.device = _resolve_device(device)
        if cascade.has_tilted:
            raise NotImplementedError(
                "tilted cascades need the tilted dense kernel, still to "
                "port from nubomedia_vca_tpu/ops/pallas/dense_pallas.py:"
                "build_dense_phase")
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
        self.n_dense_stages = max(1, int(np.searchsorted(
            cum, self.DENSE_MAX_WEAK, side="right")))
        if self.n_dense_stages >= cascade.n_stages:
            raise ValueError(
                f"cascade {cascade.name!r} has no stages beyond the dense "
                f"block ({cascade.n_stages} stages, {int(cum[-1])} weak "
                "trees)")
        self._build_tables()

        self._plan = PyramidDensePlan(
            (self.image_w, self.image_h),
            (cascade.window_w, cascade.window_h), self.levels,
            self._feat_rects, self._dense, self.n_dense_stages)
        if self.device.type == "cuda":
            self._plan.check_fits()
        dev = self.device
        self._blocks_dev = [blk.to(dev) for blk in self._blocks]
        self._maps_dev = [(torch.from_numpy(mx).long().to(dev),
                           torch.from_numpy(my).long().to(dev))
                          for mx, my in self._maps]
        self._img_poff_dev = [
            torch.from_numpy(self._img_patch_dy * l.sw
                             + self._img_patch_dx).long().to(dev)
            for l in self.levels]

    # ------------------------------------------------------------------ prep
    def _build_tables(self) -> None:
        c = self.cascade
        self._pw, self._ph = c.window_w + 1, c.window_h + 1

        # per-feature corner decomposition (sum table only: the engine
        # refuses tilted cascades)
        self._feat_rects = []
        for f in range(c.n_features):
            rects = []
            for r in range(c.rects.shape[1]):
                wgt = float(c.rect_weights[f, r])
                if wgt == 0.0:
                    continue
                x, y, w, h = (int(v) for v in c.rects[f, r])
                rects.append(("sum", _sum_corner_offsets(x, y, w, h), wgt))
            self._feat_rects.append(rects)

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

        # matmul blocks
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

        # per-level capacities for each block
        self._level_caps: list[list[int]] = []
        for l in self.levels:
            caps = []
            prev = l.n_windows
            for blk in self._blocks:
                cap = int(min(prev, self.MAX_CAPACITY,
                              max(64, int(np.ceil(l.n_windows * blk.cap_frac)))))
                caps.append(cap)
                prev = cap
            self._level_caps.append(caps)
        self.total_capacity = sum(caps[-1] for caps in self._level_caps)

        # original-pixel coordinate maps
        self._maps = []
        for l in self.levels:
            xs = (np.arange(l.nx) * l.ystep).astype(np.float64)
            ys = (np.arange(l.ny) * l.ystep).astype(np.float64)
            self._maps.append((
                np.rint(xs * l.factor).astype(np.int32),
                np.rint(ys * l.factor).astype(np.int32),
            ))

        # survivor patches are gathered from the LEVEL IMAGE (uint8, w0×h0):
        # the patch-local integral of the window's pixels equals the
        # doubly-relative integral-table patch entry for entry, so no
        # integral table has to leave the dense phase
        dyi, dxi = np.meshgrid(np.arange(self._ph - 1),
                               np.arange(self._pw - 1), indexing="ij")
        self._img_patch_dy = dyi.reshape(-1)
        self._img_patch_dx = dxi.reshape(-1)

    def _make_block(self, w_lo, w_hi, s_lo, s_hi, frac) -> _Block:
        c = self.cascade
        used = sorted(
            {int(f) for f in np.concatenate(
                [c.feat0[w_lo:w_hi], c.featL[w_lo:w_hi], c.featR[w_lo:w_hi]])}
        )
        remap = {f: i for i, f in enumerate(used)}
        PP = self._pw * self._ph
        w_sum = np.zeros((PP, len(used)), np.float32)
        for f in used:
            i = remap[f]
            for _, corners, wgt in self._feat_rects[f]:
                for (dy, dx, s) in corners:
                    assert 0 <= dy < self._ph and 0 <= dx < self._pw
                    w_sum[dy * self._pw + dx, i] += s * wgt
        onehot = np.zeros((w_hi - w_lo, s_hi - s_lo), np.float32)
        for i, s in enumerate(c.weak_stage[w_lo:w_hi]):
            onehot[i, int(s) - s_lo] = 1.0
        rm = np.vectorize(lambda f: remap[int(f)], otypes=[np.int32])
        return _Block(
            w_sum=w_sum,
            feat0=rm(c.feat0[w_lo:w_hi]), thr0=c.thr0[w_lo:w_hi],
            featL=rm(c.featL[w_lo:w_hi]), thrL=c.thrL[w_lo:w_hi],
            leavesL=c.leavesL[w_lo:w_hi],
            featR=rm(c.featR[w_lo:w_hi]), thrR=c.thrR[w_lo:w_hi],
            leavesR=c.leavesR[w_lo:w_hi],
            stage_onehot=onehot,
            stage_thr=c.stage_thresholds[s_lo:s_hi],
            cap_frac=frac,
        )

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
        """patch [B,C,PP] f32 (patch-local integral), vnf_sel [B,C] →
        pass [B,C]. The feature matmul is exact integer arithmetic in
        float32 (every partial sum < 2^24), so its summation order does not
        matter; TF32 would round the patch values."""
        feats = torch.matmul(patch, blk["w_sum"])
        vals = feats * vnf_sel[:, :, None]
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

    def _level_post(self, li, img, vnf, alive):
        """Strided dense-grid maps of level `li` → (boxes [B,cap,4] i32,
        valid [B,cap], overflow [B]): compaction, survivor patch gather
        from the level image `img` [B,sh,sw] u8, matmul blocks."""
        l, caps = self.levels[li], self._level_caps[li]
        map_x, map_y = self._maps_dev[li]
        B = alive.shape[0]
        ny, nx, step = l.ny, l.nx, l.ystep
        nwin = ny * nx
        overflow = torch.zeros((B,), dtype=torch.bool, device=alive.device)
        alive_flat = alive.reshape(B, nwin)
        vnf_flat = vnf.reshape(B, nwin)

        # first compaction + one-time patch gather
        cap0 = caps[0]
        sel, sel_alive, count = self._compact(alive_flat, cap0)
        overflow |= count > cap0
        win_ids = sel
        y, x = (sel // nx) * step, (sel % nx) * step
        k0 = sel.shape[1]
        idx = (y * l.sw + x)[:, :, None] + self._img_poff_dev[li]
        pimg = img.reshape(B, -1).gather(1, idx.reshape(B, -1)).reshape(
            B, k0, self._ph - 1, self._pw - 1)
        local = torch.cumsum(
            torch.cumsum(pimg.to(torch.int32), dim=-1, dtype=torch.int32),
            dim=-2, dtype=torch.int32)
        patch = F.pad(local, (1, 0, 1, 0)).reshape(B, k0, -1).to(
            torch.float32)
        vnf_sel = vnf_flat.gather(1, sel)

        for bi, blk in enumerate(self._blocks_dev):
            if bi > 0 and caps[bi] < sel_alive.shape[1]:
                # re-compact among current survivors
                sel2, sel_alive, count = self._compact(sel_alive, caps[bi])
                overflow |= count > caps[bi]
                win_ids = win_ids.gather(1, sel2)
                patch = patch.gather(
                    1, sel2[:, :, None].expand(-1, -1, patch.shape[2]))
                vnf_sel = vnf_sel.gather(1, sel2)
            passed = self._block_eval(blk, patch, vnf_sel)
            sel_alive = sel_alive & passed

        bx = map_x[win_ids % nx]
        by = map_y[win_ids // nx]
        boxes = torch.stack(
            [bx, by, torch.full_like(bx, l.out_w), torch.full_like(bx, l.out_h)],
            dim=-1).to(torch.int32)
        return boxes, sel_alive, overflow

    def _detect_impl(self, gray: torch.Tensor):
        """gray [B, H, W] uint8 → (boxes [B, TC, 4] i32, valid [B, TC] bool,
        overflow [B] bool)."""
        out_boxes, out_valid = [], []
        overflow = torch.zeros((gray.shape[0],), dtype=torch.bool,
                               device=gray.device)
        levels = pyramid_dense_phase(gray, self._plan)
        for li, (img_l, vnf, alive) in enumerate(levels):
            boxes, valid, ovf = self._level_post(
                li, gray if img_l is None else img_l, vnf, alive.bool())
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
        cap = min(self.RAW_GROUP_CAP, valid.shape[1])
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
        cap = min(self.RAW_GROUP_CAP, valid.shape[1])
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
               device: str | torch.device = "cpu") -> CascadeEngine:
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
