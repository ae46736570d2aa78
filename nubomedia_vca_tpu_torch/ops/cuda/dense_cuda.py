"""The pyramid dense phase: exact resize, integral tables, variance
normalization and the first cascade stages, for every level of a pyramid.

Port of the TPU kernel ``build_pyramid_dense_phase``
(``nubomedia_vca_tpu/ops/pallas/dense_pallas.py:371``). Three pieces:

* ``PyramidDensePlan`` — the host tables of one engine geometry (levels,
  resize index/coefficient tables, the dense block's features and weak
  trees), with their device copies made once per device;
* ``pyramid_dense_phase_reference`` — the plain PyTorch version: per level
  ``resize_linear_exact``, ``integral_image``/``sq_integral_image`` and the
  XLA dense phase of the JAX engine's ``_eval_level``
  (``cascade/engine.py:549-585``) on the ystep-strided window grid. It runs
  on any device;
* ``pyramid_dense_phase`` — the wrapper: on a CPU tensor it runs the plain
  version, on a CUDA tensor it launches ``csrc/pyramid_dense.cu`` (one block
  per (level, frame)) or raises. It never falls back.

Both return, per level, ``(img_l [B,sh,sw] uint8 | None, vnf [B,ny,nx]
float32, alive [B,ny,nx] uint8)``; ``img_l`` is None for the unscaled level,
whose image is the work image itself. The two agree bit for bit.
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

# Hopper's opt-in dynamic shared memory per block (227 KB).
MAX_SMEM_BYTES = 232_448
# Per-level int32 record read by the kernel (kSw..kRyOff in the .cu file).
LEVEL_FIELDS = ("sw", "sh", "step", "nx", "ny", "same", "img_base",
                "map_base", "rx_off", "ry_off")
MAX_RECTS = 3        # rects per Haar feature (kMaxRects)
MAX_GRID_Y = 65_535  # frames per launch (gridDim.y)
_TPU_KERNELS = "nubomedia_vca_tpu/ops/pallas/dense_pallas.py"


class PyramidDensePlan:
    """Host tables of the dense phase over every level of one engine.

    feat_rects: per cascade feature, the list of (table, corners, weight)
    of ``CascadeEngine._feat_rects``; dense: the engine's ``_dense`` dict.
    """

    def __init__(self, image_size: tuple[int, int],
                 window: tuple[int, int], levels: list[LevelSpec],
                 feat_rects: list, dense: dict, n_dense_stages: int):
        self.image_w, self.image_h = image_size
        self.window_w, self.window_h = window
        self.levels = tuple(levels)
        self.feat_rects = feat_rects
        self.dense = dense
        self.n_dense = n_dense_stages
        self.norm_w, self.norm_h = self.window_w - 2, self.window_h - 2
        self.norm_area = float(self.norm_w * self.norm_h)
        self.norm_corners = [(1, 1, 1), (1, 1 + self.norm_w, -1),
                             (1 + self.norm_h, 1, -1),
                             (1 + self.norm_h, 1 + self.norm_w, 1)]
        self.var_thr = 100.0 * self.norm_area * self.norm_area

        # the dense block's features, renumbered 0..n_used-1
        fids = np.concatenate([dense["feat0"], dense["featL"],
                               dense["featR"]]).astype(np.int64)
        used = sorted({int(f) for f in fids})
        remap = {f: i for i, f in enumerate(used)}
        feat_i = np.zeros((len(used), 1 + 4 * MAX_RECTS), np.int32)
        feat_w = np.zeros((len(used), MAX_RECTS), np.float32)
        for f in used:
            rects = feat_rects[f]
            if any(table != "sum" for table, _, _ in rects):
                raise NotImplementedError(
                    "tilted Haar features need the tilted dense kernel, "
                    f"still to port from {_TPU_KERNELS}:build_dense_phase")
            i = remap[f]
            feat_i[i, 0] = len(rects)
            for r, (_, corners, wgt) in enumerate(rects):
                (y, x, _), _, _, (y2, x2, _) = corners
                feat_i[i, 1 + 4 * r:5 + 4 * r] = (x, y, x2 - x, y2 - y)
                feat_w[i, r] = wgt
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

        # per-level records and resize tables
        lv = np.zeros((len(self.levels), len(LEVEL_FIELDS)), np.int32)
        rtab: list[np.ndarray] = []
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
            lv[li] = (l.sw, l.sh, l.ystep, l.nx, l.ny, int(same),
                      img_base, map_base, rx_off, ry_off)
            if not same:
                img_base += l.sh * l.sw
            map_base += l.ny * l.nx
        # per level: (unscaled, img_base, map_base) — output offsets per frame
        self.outputs = [(bool(r[5]), int(r[6]), int(r[7])) for r in lv]
        self.img_unit, self.map_unit = img_base, map_base
        self.smem_bytes = max(
            2 * 4 * (l.sh + 1) * (l.sw + 1) for l in self.levels)
        self._host = dict(
            levels=lv,
            rtab=(np.concatenate(rtab).astype(np.int32) if rtab
                  else np.zeros(1, np.int32)),
            feat_i=feat_i, feat_w=feat_w, weak_i=weak_i, weak_f=weak_f,
            stage_thr=np.asarray(dense["stage_thr"], np.float32),
        )
        self._device: dict[torch.device, dict[str, torch.Tensor]] = {}

    def check_fits(self) -> None:
        """Raise NotImplementedError when a level's integral tables exceed
        one block's shared memory: such levels need the row-strip kernel,
        still to port."""
        if self.smem_bytes > MAX_SMEM_BYTES:
            big = max(self.levels, key=lambda l: (l.sh + 1) * (l.sw + 1))
            raise NotImplementedError(
                f"level {big.sw}x{big.sh} needs {self.smem_bytes} B of "
                f"integral tables > {MAX_SMEM_BYTES} B of shared memory; "
                "levels this large need the row-strip dense kernel, still "
                f"to port from {_TPU_KERNELS}:build_dense_phase "
                "(strip_kernel)")

    def device_tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        tabs = self._device.get(device)
        if tabs is None:
            tabs = {k: torch.from_numpy(v).to(device)
                    for k, v in self._host.items()}
            self._device[device] = tabs
        return tabs


# ------------------------------------------------------------ plain version
def _dense_level_reference(plan: PyramidDensePlan, img: torch.Tensor,
                           l: LevelSpec):
    """One level image [B,sh,sw] uint8 → (vnf, alive) on the strided grid,
    in the f32 operation order of the JAX engine's XLA dense phase."""
    d = plan.dense
    ii = integral_image(img)
    sq = sq_integral_image(img)
    ny, nx, step = l.ny, l.nx, l.ystep
    corners_cache: dict = {}
    feats: dict[int, torch.Tensor] = {}

    def rect_sum(name, tab, corners):
        acc = None
        for (dy, dx, s) in corners:
            key = (name, dy, dx)
            v = corners_cache.get(key)
            if v is None:
                v = tab[:, dy:dy + (ny - 1) * step + 1:step,
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
            for _, corners, wgt in plan.feat_rects[fid]:
                term = rect_sum("ii", ii, corners).to(torch.float32) * wgt
                val = term if val is None else val + term
            feats[fid] = val
        return val

    valsum = rect_sum("ii", ii, plan.norm_corners)
    sqv = rect_sum("sq", sq, plan.norm_corners)
    # the JAX engine reads the wrapped int32 sq-sum as uint32; a window's
    # sq-sum (< 255^2 * area) is far below 2^31, so int32 is the same value
    sq_f = sqv.to(torch.float32)
    vf = valsum.to(torch.float32)
    nf = plan.norm_area * sq_f - vf * vf
    win_valid = nf > plan.var_thr
    # float32 sqrt correctly rounded on every device: PyTorch's vectorized
    # CPU float32 sqrt is not (it differs by an ulp on some inputs), the
    # float64 one rounded to float32 is
    root = torch.sqrt(torch.clamp(nf, min=1e-20).to(torch.float64)).to(
        torch.float32)
    vnf = torch.where(win_valid, torch.reciprocal(root), torch.ones_like(nf))

    alive = win_valid
    widx, n_d = 0, len(d["feat0"])
    for s_idx in range(plan.n_dense):
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
            ssum = ssum + torch.where(f0 < float(d["thr0"][widx]), lv, rv)
            widx += 1
        alive = alive & (ssum >= float(d["stage_thr"][s_idx]))
    return vnf.contiguous(), alive.to(torch.uint8).contiguous()


def pyramid_dense_phase_reference(work: torch.Tensor,
                                  plan: PyramidDensePlan):
    """Plain PyTorch version of the kernel, on ``work``'s device."""
    _check_work(work, plan)
    out = []
    for l in plan.levels:
        same = (l.sw, l.sh) == (plan.image_w, plan.image_h)
        img = work if same else resize_linear_exact(work, (l.sw, l.sh))
        vnf, alive = _dense_level_reference(plan, img, l)
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
    _P, _I, _P,                  # levels, n_levels, rtab
    _P, _P,                      # feat_i, feat_w
    _P, _P, _I,                  # weak_i, weak_f, n_weak
    _P, _I,                      # stage_thr, n_stages
    _I, _I, _F, _F, _I,          # norm_w, norm_h, norm_area, var_thr, smem
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
    rc = lib.pyramid_dense_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
        work.data_ptr(), B, plan.image_h, plan.image_w,
        t["levels"].data_ptr(), len(plan.levels), t["rtab"].data_ptr(),
        t["feat_i"].data_ptr(), t["feat_w"].data_ptr(),
        t["weak_i"].data_ptr(), t["weak_f"].data_ptr(), t["weak_i"].shape[0],
        t["stage_thr"].data_ptr(), plan.n_dense,
        plan.norm_w, plan.norm_h, plan.norm_area, plan.var_thr,
        plan.smem_bytes,
        img_out.data_ptr(), vnf_out.data_ptr(), alive_out.data_ptr())
    if rc != 0:
        msg = lib.pyramid_dense_error_string(rc).decode()
        raise RuntimeError(f"pyramid_dense kernel launch failed: {msg} ({rc})")
    pyramid_dense_phase.launches += 1

    out = []
    for l, (same, img_base, map_base) in zip(plan.levels, plan.outputs):
        img_l = None
        if not same:
            o = B * img_base
            img_l = img_out[o:o + B * l.sh * l.sw].view(B, l.sh, l.sw)
        o, n = B * map_base, B * l.ny * l.nx
        out.append((img_l, vnf_out[o:o + n].view(B, l.ny, l.nx),
                    alive_out[o:o + n].view(B, l.ny, l.nx)))
    return out


def pyramid_dense_phase(work: torch.Tensor, plan: PyramidDensePlan):
    """work [B,H,W] uint8 → per level (img_l | None, vnf, alive).

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel (counted in ``pyramid_dense_phase.launches``) or raises.
    """
    _check_work(work, plan)
    if work.device.type == "cpu":
        return pyramid_dense_phase_reference(work, plan)
    if work.device.type != "cuda":
        raise ValueError(f"no pyramid dense kernel for {work.device}")
    return _launch(work, plan)


pyramid_dense_phase.launches = 0
