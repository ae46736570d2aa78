"""The pyramid dense phase: exact resize, integral tables, variance
normalization and the first cascade stages, for a set of pyramid levels.

Port of the TPU kernel ``build_pyramid_dense_phase``
(``nubomedia_vca_tpu/ops/pallas/dense_pallas.py:371``). Pieces:

* ``DenseTables`` — the dense block of one cascade (its features, weak
  trees and normalization constants), packed for the CUDA kernels with
  device copies made once per device, and ``DenseTables.evaluate``, the
  plain PyTorch dense phase on given integral tables: the XLA dense phase
  of the JAX engine's ``_eval_level`` (``cascade/engine.py:549-585``) on
  the ystep-strided window grid. Shared with ``dense_level_cuda``;
* ``tile_records`` — the dense block's weak trees with their corner
  offsets for tables of a given row length, as the kernels' shared record
  evaluator reads them (``csrc/dense_eval.cuh``, ``eval_records``);
* ``PyramidDensePlan`` — the host tables of one set of levels (the JAX
  kernel's ``lis`` chunk, and the levels its row-strip kernel takes):
  level records, resize index/coefficient tables, each level's tree
  records, and the work list of bands (``pyramid_bands``) that the
  kernel's blocks take;
* ``pyramid_dense_phase_reference`` — the plain version: per level
  ``resize_linear_exact``, ``integral_image``/``sq_integral_image`` and
  ``DenseTables.evaluate`` on whole-level tables. It runs on any device;
* ``pyramid_dense_phase`` — the wrapper: on a CPU tensor it runs the plain
  version, on a CUDA tensor it launches ``csrc/pyramid_dense.cu`` (one block
  per (band, frame)) or raises. It never falls back.

Both return, per level, ``(img_l [B,sh,sw] uint8 | None, vnf [B,ny,nx]
float32, alive [B,ny,nx] uint8)``; ``img_l`` is None for the unscaled level,
whose image is the work image itself. The two agree bit for bit: a rect
sum is a 4-corner difference, so band-local tables give the whole-level
table's sums (uint32 wraparound).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...cascade.pyramid import LevelSpec
from ..integral import integral_image, sq_integral_image
from ..resize import _linear_exact_tables, resize_linear_exact
from . import _build

# Hopper's opt-in dynamic shared memory per block (227 KB), and the shared
# memory of an SM, of which each resident block also takes 1 KB
MAX_SMEM_BYTES = 232_448
SM_SMEM_BYTES = 233_472
# Per-level int32 record read by the kernel (kSw..kRecOff in the .cu file).
LEVEL_FIELDS = ("sw", "sh", "step", "nx", "ny", "same", "img_base",
                "map_base", "rx_off", "ry_off", "rec_off")
# Per-band int32 record (kLevel..kOwn1): the level, its first grid row and
# grid rows, its first level row and the level rows it tabulates, and the
# end of the level rows whose image it writes.
ITEM_FIELDS = ("level", "iy0", "n_rows", "row0", "rows", "own1")
MAX_RECTS = 3        # rects per Haar feature (kMaxRects in dense_eval.cuh)
MAX_GRID_Y = 65_535  # frames per launch (gridDim.y)
# a weak tree's record (kTreeWords in dense_eval.cuh): its three features of
# FEAT_WORDS, its 7 thresholds and leaves, its stage
FEAT_WORDS = 2 + 5 * MAX_RECTS
TREE_WORDS = 3 * FEAT_WORDS + 8
# windows per band of the pyramid kernel: two a thread of a 256-thread block
BAND_WINDOWS = 512
# shared memory a band may take before it is cut below a window's height of
# rows (pyramid_bands): three blocks an SM. On an H100 the nose's 24-level
# launch took 457-463 us of kernel time in bands within this, 536-554 us in
# bands of a window's height (107 KB, two blocks an SM) and 571-600 us in
# bands within a quarter (four an SM, 202 bands).
BAND_SMEM_TARGET = SM_SMEM_BYTES // 3 - 1024


def pyramid_smem_bytes(l: LevelSpec) -> int:
    """Bytes of a level's whole sum and squared-sum tables, 4 B per element
    each. A level above MAX_SMEM_BYTES is *wide*: the row-strip form of the
    TPU kernel (``dense_pallas.py:276``) took such levels, the pyramid
    kernel takes them in bands like any other."""
    return 2 * 4 * (l.sh + 1) * (l.sw + 1)


def band_table_bytes(l: LevelSpec, win_h: int, n_rows: int) -> int:
    """Bytes of the two tables of a band of `n_rows` grid rows of level
    `l`: its grid rows and the window_h - ystep halo rows below them, plus
    the zero row."""
    return 8 * ((n_rows - 1) * l.ystep + win_h + 1) * (l.sw + 1)


def pyramid_fits(l: LevelSpec, win_h: int) -> bool:
    """Whether the pyramid kernel takes level `l`: the two tables of a band
    of one grid row (window_h level rows) fit one block's shared memory.
    For a level of ystep 2 this reaches 1382 px wide for a 20-px window and
    1161 px for a 24-px window, beyond the 1319 and 1116 px that a strip of
    one window row of the row-strip kernel it replaces reached (at ystep 1
    the two limits are equal)."""
    return band_table_bytes(l, win_h, 1) <= MAX_SMEM_BYTES


def pyramid_bands(l: LevelSpec, win_h: int, record_bytes: int,
                  target: int) -> list[tuple[int, int]]:
    """The bands of level `l` in the pyramid kernel → (first grid row, grid
    rows) each: about BAND_WINDOWS windows a band, and at least window_h level
    rows a band, so that the halo (window_h - ystep rows) is at most about
    the band's own rows; the level's grid rows split as evenly as that
    count allows. A small level is one band. Where such a band's tables and
    `record_bytes` would exceed `target` bytes, the bands are cut shorter,
    down to one grid row."""
    per = max(-(-BAND_WINDOWS // l.nx), -(-win_h // l.ystep))
    n = max(1, min(l.ny, int(l.ny / per + 0.5)))
    spare = (target - record_bytes) // (8 * (l.sw + 1)) - 1 - win_h
    fit = spare // l.ystep + 1 if spare >= 0 else 1
    return _split(l.ny, min(l.ny, max(n, -(-l.ny // fit))))


def _split(ny: int, n: int) -> list[tuple[int, int]]:
    base, extra = divmod(ny, n)
    bands, iy = [], 0
    for k in range(n):
        rows = base + (k < extra)
        bands.append((iy, rows))
        iy += rows
    return bands


def band_item(l: LevelSpec, win_h: int, iy0: int, n_rows: int) -> tuple:
    """(row0, rows, own1) of a band: its first level row, the level rows it
    resizes and tabulates (grid rows and halo) and the end of the rows
    whose image it writes (for the last band the level's end, past the
    rows any window reads)."""
    row0 = iy0 * l.ystep
    own1 = l.sh if iy0 + n_rows == l.ny else (iy0 + n_rows) * l.ystep
    return row0, (n_rows - 1) * l.ystep + win_h, own1


def tile_records(tables: "DenseTables", pitch: int) -> np.ndarray:
    """The dense block's weak trees as the record evaluator reads them, for
    tables of row length `pitch` → int32 [n_weak, TREE_WORDS]: per tree its
    root, left and right features (n rects, tilted flag, the 4 corner
    offsets of each rect from the window's origin, the rects' weights as
    float32 bits), then thr0, thrL, thrR, the left and right leaves
    (float32 bits) and the stage. Both rect kinds are the signed corner sum
    t[o0] - t[o1] - t[o2] + t[o3]."""
    fi, fw = tables.host["feat_i"], tables.host["feat_w"]
    feats = np.zeros((len(fi), FEAT_WORDS), np.int32)
    for f, rec in enumerate(fi):
        feats[f, :2] = rec[0], rec[-1]
        for r in range(rec[0]):
            x, y, w, h = (int(v) for v in rec[1 + 4 * r:5 + 4 * r])
            corners = ([(y, x), (y + w, x + w), (y + h, x - h),
                        (y + w + h, x + w - h)] if rec[-1] else
                       [(y, x), (y, x + w), (y + h, x), (y + h, x + w)])
            feats[f, 2 + 4 * r:6 + 4 * r] = [cy * pitch + cx
                                             for cy, cx in corners]
    feats[:, 2 + 4 * MAX_RECTS:] = fw.view(np.int32)
    wi, wf = tables.host["weak_i"], tables.host["weak_f"]
    return np.concatenate([feats[wi[:, 0]], feats[wi[:, 1]], feats[wi[:, 2]],
                           wf.view(np.int32), wi[:, 3:]], axis=1)


class DenseTables:
    """The dense block (first ``n_dense_stages`` stages) of one cascade.

    feat_rects: per cascade feature, the list of (table, corners, weight)
    of ``CascadeEngine._feat_rects`` (table "sum" or "tilt"); dense: the
    engine's ``_dense`` dict. ``tilted`` says whether a feature of the
    dense block reads the tilted table.
    """

    def __init__(self, window: tuple[int, int], feat_rects: list,
                 dense: dict, n_dense_stages: int):
        self.window_w, self.window_h = window
        self.feat_rects = feat_rects
        self.dense = dense
        self.n_dense = n_dense_stages
        self.norm_w, self.norm_h = self.window_w - 2, self.window_h - 2
        self.norm_area = float(self.norm_w * self.norm_h)
        self.norm_corners = [(1, 1, 1), (1, 1 + self.norm_w, -1),
                             (1 + self.norm_h, 1, -1),
                             (1 + self.norm_h, 1 + self.norm_w, 1)]
        self.var_thr = 100.0 * self.norm_area * self.norm_area

        # the dense block's features, renumbered 0..n_used-1; per feature
        # n_rects, (x, y, w, h) per rect, tilted flag (dense_eval.cuh)
        fids = np.concatenate([dense["feat0"], dense["featL"],
                               dense["featR"]]).astype(np.int64)
        used = sorted({int(f) for f in fids})
        remap = {f: i for i, f in enumerate(used)}
        feat_i = np.zeros((len(used), 2 + 4 * MAX_RECTS), np.int32)
        feat_w = np.zeros((len(used), MAX_RECTS), np.float32)
        self.tilted = False
        for f in used:
            rects = feat_rects[f]
            i = remap[f]
            feat_i[i, 0] = len(rects)
            for r, (table, corners, wgt) in enumerate(rects):
                (y, x, _), (_, x1, _), (y2, _, _), _ = corners
                feat_i[i, 1 + 4 * r:5 + 4 * r] = (x, y, x1 - x, y2 - y)
                feat_w[i, r] = wgt
                if table == "tilt":
                    feat_i[i, -1] = 1
                    self.tilted = True
        rm = np.vectorize(lambda f: remap[int(f)], otypes=[np.int32])
        n_weak = len(dense["feat0"])
        weak_i = np.zeros((n_weak, 4), np.int32)
        weak_f = np.zeros((n_weak, 7), np.float32)
        if n_weak:
            weak_i[:] = np.stack([rm(dense["feat0"]), rm(dense["featL"]),
                                  rm(dense["featR"]), dense["stage"]], 1)
            weak_f[:] = np.concatenate(
                [np.stack([dense["thr0"], dense["thrL"], dense["thrR"]], 1),
                 dense["leavesL"], dense["leavesR"]], 1)
        self.host = dict(feat_i=feat_i, feat_w=feat_w, weak_i=weak_i,
                         weak_f=weak_f,
                         stage_thr=np.asarray(dense["stage_thr"], np.float32))
        self._device: dict[torch.device, dict[str, torch.Tensor]] = {}

    def device_tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        tabs = self._device.get(device)
        if tabs is None:
            tabs = {k: torch.from_numpy(v).to(device)
                    for k, v in self.host.items()}
            self._device[device] = tabs
        return tabs

    # ------------------------------------------------------- plain version
    def evaluate(self, ii: torch.Tensor, sq: torch.Tensor,
                 iit: torch.Tensor | None, ny: int, nx: int, step: int):
        """Integral tables [B, rows+1, sw+1] int32 → (vnf, alive) of the
        ny x nx window grid with origins (iy*step, ix*step), in the float32
        operation order of the JAX engine's XLA dense phase."""
        d = self.dense
        corners_cache: dict = {}
        feats: dict[int, torch.Tensor] = {}
        tabs = {"ii": ii, "sq": sq, "tilt": iit}

        def rect_sum(name, corners):
            acc = None
            for (dy, dx, s) in corners:
                key = (name, dy, dx)
                v = corners_cache.get(key)
                if v is None:
                    v = tabs[name][:, dy:dy + (ny - 1) * step + 1:step,
                                   dx:dx + (nx - 1) * step + 1:step]
                    corners_cache[key] = v
                if acc is None:
                    acc = v if s > 0 else -v
                else:
                    acc = acc + v if s > 0 else acc - v
            return acc   # int32, exact (wraparound)

        def feature(fid):
            val = feats.get(fid)
            if val is None:
                for table, corners, wgt in self.feat_rects[fid]:
                    name = "ii" if table == "sum" else "tilt"
                    term = rect_sum(name, corners).to(torch.float32) * wgt
                    val = term if val is None else val + term
                feats[fid] = val
            return val

        valsum = rect_sum("ii", self.norm_corners)
        sqv = rect_sum("sq", self.norm_corners)
        # the JAX engine reads the wrapped int32 sq-sum as uint32; a
        # window's sq-sum (< 255^2 * area) is far below 2^31, so int32 is
        # the same value
        sq_f = sqv.to(torch.float32)
        vf = valsum.to(torch.float32)
        nf = self.norm_area * sq_f - vf * vf
        win_valid = nf > self.var_thr
        # float32 sqrt correctly rounded on every device: PyTorch's
        # vectorized CPU float32 sqrt is not (it differs by an ulp on some
        # inputs), the float64 one rounded to float32 is
        root = torch.sqrt(torch.clamp(nf, min=1e-20).to(torch.float64)).to(
            torch.float32)
        vnf = torch.where(win_valid, torch.reciprocal(root),
                          torch.ones_like(nf))

        alive = win_valid
        widx, n_d = 0, len(d["feat0"])
        for s_idx in range(self.n_dense):
            ssum = torch.zeros_like(vnf)
            while widx < n_d and d["stage"][widx] == s_idx:
                f0 = feature(int(d["feat0"][widx])) * vnf
                fL = feature(int(d["featL"][widx])) * vnf
                fR = feature(int(d["featR"][widx])) * vnf
                lL, lR = d["leavesL"][widx], d["leavesR"][widx]
                lv = torch.where(fL < float(d["thrL"][widx]),
                                 float(lL[0]), float(lL[1]))
                rv = torch.where(fR < float(d["thrR"][widx]),
                                 float(lR[0]), float(lR[1]))
                ssum = ssum + torch.where(f0 < float(d["thr0"][widx]),
                                          lv, rv)
                widx += 1
            alive = alive & (ssum >= float(d["stage_thr"][s_idx]))
        return vnf.contiguous(), alive.to(torch.uint8).contiguous()


class PyramidDensePlan:
    """Host tables of the pyramid kernel over a set of levels of one engine
    (the JAX kernel's chunk ``lis``, and the wide levels its row-strip
    kernel took): per-level records, resize tables and tree records (corner
    offsets for the level's row length, sw + 1), and the kernel's work list
    of bands (``items``, ITEM_FIELDS per band; the bands of each level from
    ``pyramid_bands`` with at most `band_target` bytes of shared memory
    where a band can, levels in order).

    The kernel's blocks copy their level's tree records and stage
    thresholds to shared memory when they fit beside every level's largest
    band (``staged``), and read them through L1 otherwise.
    ``band_smem_bytes`` is the launch's dynamic shared memory: the largest
    band's two tables and, if staged, the records; ``n_wide`` counts the
    wide levels (``pyramid_smem_bytes`` above MAX_SMEM_BYTES)."""

    def __init__(self, image_size: tuple[int, int], levels: list[LevelSpec],
                 tables: DenseTables, band_target: int = BAND_SMEM_TARGET):
        if tables.tilted:
            raise ValueError(
                "the pyramid kernel takes non-tilted dense blocks; tilted "
                "levels go to ops/cuda/dense_level_cuda.py")
        self.image_w, self.image_h = image_size
        self.levels = tuple(levels)
        self.tables = tables
        win_h = tables.window_h
        n_rec = len(tables.host["weak_i"]) * TREE_WORDS
        rec_bytes = 4 * (n_rec + tables.n_dense)

        # per-level records, resize tables and tree records; the bands
        lv = np.zeros((len(self.levels), len(LEVEL_FIELDS)), np.int32)
        rtab: list[np.ndarray] = []
        recs: list[np.ndarray] = []
        items: list[tuple] = []
        tab = 0
        off = img_base = map_base = 0
        for li, l in enumerate(self.levels):
            same = (l.sw, l.sh) == (self.image_w, self.image_h)
            rx_off = ry_off = 0
            if not same:
                rx = np.concatenate(_linear_exact_tables(self.image_w, l.sw))
                ry = np.concatenate(_linear_exact_tables(self.image_h, l.sh))
                rx_off, ry_off = off, off + rx.size
                rtab += [rx, ry]
                off += rx.size + ry.size
            bands = pyramid_bands(l, win_h, rec_bytes, band_target)
            tab = max([tab] + [band_table_bytes(l, win_h, n)
                               for _, n in bands])
            lv[li] = (l.sw, l.sh, l.ystep, l.nx, l.ny, int(same),
                      img_base, map_base, rx_off, ry_off, li * n_rec)
            recs.append(tile_records(tables, l.sw + 1).reshape(-1))
            items += [(li, iy0, n, *band_item(l, win_h, iy0, n))
                      for iy0, n in bands]
            if not same:
                img_base += l.sh * l.sw
            map_base += l.ny * l.nx
        # per level: (unscaled, img_base, map_base) — output offsets per frame
        self.outputs = [(bool(r[5]), int(r[6]), int(r[7])) for r in lv]
        self.img_unit, self.map_unit = img_base, map_base
        self.items = np.asarray(items, np.int32).reshape(-1, len(ITEM_FIELDS))
        self.staged = tab + rec_bytes <= MAX_SMEM_BYTES
        self.band_smem_bytes = tab + self.staged * rec_bytes
        self.n_wide = sum(pyramid_smem_bytes(l) > MAX_SMEM_BYTES
                          for l in self.levels)
        self._host = dict(
            levels=lv,
            items=self.items,
            rtab=(np.concatenate(rtab).astype(np.int32) if rtab
                  else np.zeros(1, np.int32)),
            records=np.concatenate(recs).astype(np.int32),
        )
        self._device: dict[torch.device, dict[str, torch.Tensor]] = {}
        self._views: dict[int, tuple] = {}

    def check_fits(self) -> None:
        """Raise ValueError when a band of one grid row of a level does not
        fit one block's shared memory (the engine gives such a level no
        route)."""
        if self.band_smem_bytes > MAX_SMEM_BYTES:
            big = max(self.levels, key=lambda l: l.sw)
            raise ValueError(
                f"level {big.sw}x{big.sh} needs {self.band_smem_bytes} B of "
                f"band tables > {MAX_SMEM_BYTES} B of shared memory; the "
                "pyramid kernel takes only levels whose bands fit")

    def output_views(self, B: int) -> tuple:
        """(sizes, shapes) of the level images and of the maps in the
        kernel's flat outputs for B frames, as ``level_outputs`` splits
        them; built once per batch size."""
        views = self._views.get(B)
        if views is None:
            img = [(B * l.sh * l.sw, (B, l.sh, l.sw))
                   for l, (same, _, _) in zip(self.levels, self.outputs)
                   if not same]
            maps = [(B * l.ny * l.nx, (B, l.ny, l.nx)) for l in self.levels]
            views = self._views[B] = (
                [n for n, _ in img], [s for _, s in img],
                [n for n, _ in maps], [s for _, s in maps],
                [same for same, _, _ in self.outputs])
        return views

    def device_tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        tabs = self._device.get(device)
        if tabs is None:
            tabs = {k: torch.from_numpy(v).to(device)
                    for k, v in self._host.items()}
            self._device[device] = tabs
        return tabs


# ------------------------------------------------------------ plain version
def pyramid_dense_phase_reference(work: torch.Tensor,
                                  plan: PyramidDensePlan):
    """Plain PyTorch version of the kernel, on ``work``'s device."""
    _check_work(work, plan)
    out = []
    for l in plan.levels:
        same = (l.sw, l.sh) == (plan.image_w, plan.image_h)
        img = work if same else resize_linear_exact(work, (l.sw, l.sh))
        vnf, alive = plan.tables.evaluate(
            integral_image(img), sq_integral_image(img), None,
            l.ny, l.nx, l.ystep)
        out.append((None if same else img, vnf, alive))
    return out


# ------------------------------------------------------------------ kernel
def _check_work(work: torch.Tensor, plan: PyramidDensePlan) -> None:
    if work.dtype != torch.uint8:
        raise TypeError(f"work image must be uint8, got {work.dtype}")
    if work.ndim != 3 or tuple(work.shape[1:]) != (plan.image_h,
                                                   plan.image_w):
        raise ValueError(
            f"work image must be [B, {plan.image_h}, {plan.image_w}], "
            f"got {tuple(work.shape)}")
    if not work.is_contiguous():
        raise ValueError("work image must be contiguous")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LAUNCH_ARGTYPES = [
    _I, _P,                      # device, stream
    _P, _I, _I, _I,              # work, B, H, W
    _P, _P, _I, _P,              # levels, items, n_items, rtab
    _P, _I, _P, _I,              # trees, n_weak, stage_thr, n_stages
    _I, _I, _F, _F,              # norm_w, norm_h, norm_area, var_thr
    _I, _I,                      # smem, staged
    _P, _P, _P,                  # img_out, vnf_out, alive_out
]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("pyramid_dense")
    lib.pyramid_dense_launch.argtypes = _LAUNCH_ARGTYPES
    lib.pyramid_dense_launch.restype = ctypes.c_int
    lib.pyramid_dense_error_string.argtypes = [ctypes.c_int]
    lib.pyramid_dense_error_string.restype = ctypes.c_char_p
    return lib


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch(work: torch.Tensor, plan: PyramidDensePlan):
    plan.check_fits()
    B = work.shape[0]
    if not 1 <= B <= MAX_GRID_Y:
        raise ValueError(f"1 to {MAX_GRID_Y} frames per launch, got {B}")
    lib = _library()
    dev = work.device
    t = plan.device_tables(dev)
    img_out = torch.empty(max(B * plan.img_unit, 1), dtype=torch.uint8,
                          device=dev)
    vnf_out = torch.empty(B * plan.map_unit, dtype=torch.float32, device=dev)
    alive_out = torch.empty(B * plan.map_unit, dtype=torch.uint8, device=dev)
    tabs = plan.tables
    rc = lib.pyramid_dense_launch(
        device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
        work.data_ptr(), B, plan.image_h, plan.image_w,
        t["levels"].data_ptr(), t["items"].data_ptr(), len(plan.items),
        t["rtab"].data_ptr(), t["records"].data_ptr(),
        len(tabs.host["weak_i"]),
        tabs.device_tables(dev)["stage_thr"].data_ptr(), tabs.n_dense,
        tabs.norm_w, tabs.norm_h, tabs.norm_area, tabs.var_thr,
        plan.band_smem_bytes, int(plan.staged), img_out.data_ptr(),
        vnf_out.data_ptr(), alive_out.data_ptr())
    if rc != 0:
        msg = lib.pyramid_dense_error_string(rc).decode()
        raise RuntimeError(f"pyramid_dense kernel launch failed: {msg} ({rc})")
    pyramid_dense_phase.launches += 1
    if plan.n_wide:
        pyramid_dense_phase.wide_launches += 1
    return level_outputs(plan, B, img_out, vnf_out, alive_out)


def level_outputs(plan: PyramidDensePlan, B: int, img_out: torch.Tensor,
                  vnf_out: torch.Tensor, alive_out: torch.Tensor):
    """The kernel's flat outputs as per-level (img_l | None, vnf, alive)
    views: each level's block of B frames at B times its per-frame
    offset, split by the sizes the plan holds for B."""
    img_n, img_s, map_n, map_s, same = plan.output_views(B)
    imgs = iter([t.view(s) for t, s in zip(
        img_out.split_with_sizes(img_n), img_s)] if img_n else [])
    vnfs = vnf_out.split_with_sizes(map_n)
    alives = alive_out.split_with_sizes(map_n)
    return [(None if u else next(imgs), v.view(s), a.view(s))
            for u, v, a, s in zip(same, vnfs, alives, map_s)]


def pyramid_dense_phase(work: torch.Tensor, plan: PyramidDensePlan):
    """work [B,H,W] uint8 → per level of the plan (img_l | None, vnf, alive).

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel (counted in ``pyramid_dense_phase.launches``, and in
    ``pyramid_dense_phase.wide_launches`` when the plan holds a wide level)
    or raises.
    """
    _check_work(work, plan)
    if work.device.type == "cpu":
        return pyramid_dense_phase_reference(work, plan)
    if work.device.type != "cuda":
        raise ValueError(f"no pyramid dense kernel for {work.device}")
    return _launch(work, plan)


pyramid_dense_phase.launches = 0
pyramid_dense_phase.wide_launches = 0
