"""The dense phase of one pre-resized pyramid level: integral tables,
variance normalization and the cascade's dense block on the level's
ystep-strided window grid.

Port of the TPU kernel ``build_dense_phase``
(``nubomedia_vca_tpu/ops/pallas/dense_pallas.py:221``) in its two forms,
both in ``csrc/dense_level.cu``:

* ``dense_level_tilted`` — the tilted form (``pallas_call`` :329), which
  also emits the sum and tilted tables for the survivor patch gather. A
  table pass in device memory, then a tiled evaluation: the sum and
  squared-sum tables (``integral_cuda.integral_tables``), the tilted table
  built from the sum table (``tilted_table``), then one block per (tile,
  frame) that stages the tile's window of the three tables in shared
  memory and evaluates its ``tile_ny`` x ``tile_nx`` strided windows.
  Shared memory is sized by the tile, not by the level, so every level of
  a tilted cascade takes it;
* ``dense_level_strips`` — the row-strip kernel (``strip_kernel`` :276,
  ``pallas_call`` :300): non-tilted levels in strips of ``strip_gy``
  window rows with an (h0-1)-row halo, one block per (strip, frame); with
  one strip it is the non-tilted single block.

``DenseLevelPlan`` holds a level's geometry and its strips or tiles;
``dense_level_reference`` is the plain PyTorch version of both forms (the
strip form builds strip-local tables, and the tilted form evaluates tile by
tile on the level's tables, exactly as the kernels cut the level). A
wrapper runs the plain version for a CPU tensor and launches the kernels
for a CUDA tensor, or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...cascade.pyramid import LevelSpec
from ..integral import (integral_image, sq_integral_image,
                        tilted_from_integral, tilted_integral_image)
from . import _build
from .dense_cuda import (CASCADE_ARGTYPES, MAX_GRID_Y, MAX_SMEM_BYTES,
                         TREE_WORDS, DenseTables, device_index, tile_records)
from .integral_cuda import integral_tables

# strided windows per evaluation tile (rows, columns): one thread per
# window of a full tile (kEvalThreads in csrc/dense_level.cu)
TILE = (16, 16)


def tile_shape(l: LevelSpec, tables: DenseTables,
               tile: tuple[int, int] = TILE) -> tuple[int, int]:
    """(rows, columns) of the tables that a full tile of level `l` stages
    (a tile larger than the level is cut to it); the columns are the row
    length of every staged tile of the level."""
    step = l.ystep
    return ((min(tile[0], l.ny) - 1) * step + tables.window_h + 1,
            (min(tile[1], l.nx) - 1) * step + tables.window_w + 1)


def tile_smem_bytes(l: LevelSpec, tables: DenseTables,
                    tile: tuple[int, int] = TILE) -> int:
    """Dynamic shared memory of a block of the evaluation kernel: a full
    tile's window of the sum, squared-sum and tilted tables, and the
    cascade's tree records and stage thresholds, 4 B per element each."""
    rows, cols = tile_shape(l, tables, tile)
    n_weak = len(tables.host["weak_i"])
    return 4 * (3 * rows * cols + n_weak * TREE_WORDS + tables.n_dense)


def tilted_fits(l: LevelSpec, tables: DenseTables,
                max_smem: int = MAX_SMEM_BYTES,
                tile: tuple[int, int] = TILE) -> bool:
    """Whether the tilted kernels take level `l`: a block of the evaluation
    kernel within `max_smem` bytes of shared memory."""
    return tile_smem_bytes(l, tables, tile) <= max_smem


def strip_plan(l: LevelSpec, win_h: int,
               max_smem: int = MAX_SMEM_BYTES) -> tuple[int, int] | None:
    """Row strips of a non-tilted level whose two strip tables fit
    `max_smem` bytes → (strip_gy, n_strips), or None when even a strip of
    one window row does not fit. strip_gy (window-origin rows per strip) is
    a multiple of the level's ystep, so the strided grid rows land on local
    rows 0, ystep, ... of every strip; the last strip may be ragged."""
    gy = l.sh - win_h + 1
    max_rows = max_smem // (8 * (l.sw + 1)) - 1       # level rows per strip
    strip_gy = (max_rows - win_h + 1) // l.ystep * l.ystep
    if strip_gy < l.ystep:
        return None
    strip_gy = min(strip_gy, -(-gy // l.ystep) * l.ystep)
    return strip_gy, -(-gy // strip_gy)


@dataclasses.dataclass(frozen=True)
class DenseLevelPlan:
    """One level of one engine for the level kernels: tilted (tiles of
    ``tile_ny`` x ``tile_nx`` strided windows, staged as ``tile_rows`` rows
    of ``pitch`` table entries, and the tree records for that pitch) or row
    strips."""

    level: LevelSpec
    tables: DenseTables
    tilted: bool
    strip_gy: int       # strips: window-origin rows per strip (0 if tilted)
    n_strips: int
    tile_ny: int        # tilted: strided windows per tile (0 for strips)
    tile_nx: int
    tile_rows: int      # tilted: table rows and row length of a full tile
    pitch: int
    smem_bytes: int     # dynamic shared memory of one block
    records: np.ndarray | None = dataclasses.field(default=None,
                                                   compare=False)
    _device: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @classmethod
    def make(cls, level: LevelSpec, tables: DenseTables, tilted: bool,
             max_smem: int = MAX_SMEM_BYTES,
             tile: tuple[int, int] = TILE) -> "DenseLevelPlan":
        """The level's plan; raises ValueError when a block's tables do not
        fit `max_smem` (tilted: a tile and the tree records; otherwise a
        one-row strip)."""
        h0 = tables.window_h
        if tilted:
            if not tilted_fits(level, tables, max_smem, tile):
                raise ValueError(
                    f"tilted level {level.sw}x{level.sh}: a tile of "
                    f"{tile[0]}x{tile[1]} windows needs "
                    f"{tile_smem_bytes(level, tables, tile)} B > {max_smem} "
                    "B of shared memory")
            rows, pitch = tile_shape(level, tables, tile)
            return cls(level, tables, True, 0, 0, tile[0], tile[1], rows,
                       pitch, tile_smem_bytes(level, tables, tile),
                       tile_records(tables, pitch))
        if tables.tilted:
            raise ValueError("the strip kernel takes non-tilted dense blocks")
        plan = strip_plan(level, h0, max_smem)
        if plan is None:
            raise ValueError(
                f"level {level.sw}x{level.sh} is too wide for a row strip "
                f"in {max_smem} B of shared memory")
        strip_gy, n_strips = plan
        rows = min(strip_gy + h0 - 1, level.sh)
        return cls(level, tables, False, strip_gy, n_strips, 0, 0, 0, 0,
                   8 * (rows + 1) * (level.sw + 1))

    def strips(self):
        """(first level row, level rows, grid rows) of each strip, as the
        kernel's blocks cut them."""
        l, h0 = self.level, self.tables.window_h
        for s in range(self.n_strips):
            row0 = s * self.strip_gy
            iy1 = min(l.ny, (row0 + self.strip_gy) // l.ystep)
            yield (row0, min(self.strip_gy + h0 - 1, l.sh - row0),
                   iy1 - row0 // l.ystep)

    def device_records(self, device: torch.device) -> torch.Tensor:
        """The tree records on `device`, copied once."""
        recs = self._device.get(device)
        if recs is None:
            recs = torch.from_numpy(self.records).to(device)
            self._device[device] = recs
        return recs

    @property
    def n_tiles(self) -> tuple[int, int]:
        """Tiles down and across the level's window grid."""
        l = self.level
        return -(-l.ny // self.tile_ny), -(-l.nx // self.tile_nx)

    def tiles(self):
        """(first grid row, grid rows, first grid column, grid columns) of
        each tile, in the order of the evaluation kernel's blocks; the last
        tile of a row or column is ragged."""
        l = self.level
        n_ty, n_tx = self.n_tiles
        for ty in range(n_ty):
            iy0 = ty * self.tile_ny
            for tx in range(n_tx):
                ix0 = tx * self.tile_nx
                yield (iy0, min(self.tile_ny, l.ny - iy0),
                       ix0, min(self.tile_nx, l.nx - ix0))


# ------------------------------------------------------------ plain version
def _evaluate_tiles(plan: DenseLevelPlan, ii, sq, iit):
    """The dense block tile by tile: each tile's window of the three
    tables, rows iy0*step .. (iy0 + n_rows - 1)*step + h0 and the matching
    columns, as the kernel stages it (zero-padded to a full tile, whose
    extra windows are dropped), all tiles evaluated in one batch."""
    l, tabs = plan.level, plan.tables
    step, B = l.ystep, ii.shape[0]
    R, C = plan.tile_rows, plan.pitch       # a full tile, cut to the level
    ty, tx = min(plan.tile_ny, l.ny), min(plan.tile_nx, l.nx)
    tiles = list(plan.tiles())

    def staged(tab):
        parts = []
        for iy0, n_rows, ix0, n_cols in tiles:
            rows = (n_rows - 1) * step + tabs.window_h + 1
            cols = (n_cols - 1) * step + tabs.window_w + 1
            r0, c0 = iy0 * step, ix0 * step
            parts.append(F.pad(tab[:, r0:r0 + rows, c0:c0 + cols],
                               (0, C - cols, 0, R - rows)))
        return torch.stack(parts, 1).reshape(B * len(tiles), R, C)

    vnf_t, alive_t = tabs.evaluate(staged(ii), staged(sq), staged(iit),
                                   ty, tx, step)
    vnf_t = vnf_t.reshape(B, len(tiles), ty, tx)
    alive_t = alive_t.reshape(vnf_t.shape)
    vnf = torch.empty((B, l.ny, l.nx), dtype=torch.float32, device=ii.device)
    alive = torch.empty((B, l.ny, l.nx), dtype=torch.uint8, device=ii.device)
    for t, (iy0, n_rows, ix0, n_cols) in enumerate(tiles):
        vnf[:, iy0:iy0 + n_rows, ix0:ix0 + n_cols] = vnf_t[:, t, :n_rows,
                                                           :n_cols]
        alive[:, iy0:iy0 + n_rows, ix0:ix0 + n_cols] = alive_t[:, t, :n_rows,
                                                               :n_cols]
    return vnf, alive


def dense_level_reference(img: torch.Tensor, plan: DenseLevelPlan):
    """Plain PyTorch version of both forms, on ``img``'s device → tilted:
    (ii, iit, vnf, alive); strips: (None, None, vnf, alive)."""
    _check_img(img, plan)
    l, tabs = plan.level, plan.tables
    if plan.tilted:
        ii, iit = integral_image(img), tilted_integral_image(img)
        vnf, alive = _evaluate_tiles(plan, ii, sq_integral_image(img), iit)
        return ii, iit, vnf, alive
    vnfs, alives = [], []
    for row0, rows, n_rows in plan.strips():
        x = img[:, row0:row0 + rows]
        vnf, alive = tabs.evaluate(integral_image(x), sq_integral_image(x),
                                   None, n_rows, l.nx, l.ystep)
        vnfs.append(vnf)
        alives.append(alive)
    return None, None, torch.cat(vnfs, 1), torch.cat(alives, 1)


# ------------------------------------------------------------------ kernels
def _check_img(img: torch.Tensor, plan: DenseLevelPlan) -> None:
    l = plan.level
    if img.dtype != torch.uint8:
        raise TypeError(f"level image must be uint8, got {img.dtype}")
    if img.ndim != 3 or tuple(img.shape[1:]) != (l.sh, l.sw):
        raise ValueError(f"level image must be [B, {l.sh}, {l.sw}], got "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("level image must be contiguous")


def _check_frames(B: int) -> None:
    if not 1 <= B <= MAX_GRID_Y:
        raise ValueError(f"1 to {MAX_GRID_Y} frames per launch, got {B}")


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("dense_level")
    lib.dense_strips_launch.argtypes = [
        _I, _P,                      # device, stream
        _P, _I, _I, _I,              # img, B, sh, sw
        _I, _I, _I,                  # step, nx, ny
        _I, _I, _I,                  # strip_gy, n_strips, win_h
        *CASCADE_ARGTYPES,
        _I,                          # smem
        _P, _P,                      # vnf_out, alive_out
    ]
    lib.tilted_table_launch.argtypes = [
        _I, _P,                      # device, stream
        _P, _I, _I, _I,              # ii, B, H, W
        _P,                          # iit_out
    ]
    lib.tilted_eval_launch.argtypes = [
        _I, _P,                      # device, stream
        _P, _P, _P,                  # ii, sq, iit
        _I, _I, _I,                  # B, sh, sw
        _I, _I, _I,                  # step, nx, ny
        _I, _I, _I, _I,              # tile_ny, tile_nx, n_tiles_y, n_tiles_x
        _I, _I, _I, _I,              # win_h, win_w, tile_rows, pitch
        _P, _I, _P, _I,              # trees, n_weak, stage_thr, n_stages
        _I, _I, ctypes.c_float, ctypes.c_float,  # norm_w, norm_h, area, var
        _I,                          # smem
        _P, _P,                      # vnf_out, alive_out
    ]
    for name in ("dense_strips_launch", "tilted_table_launch",
                 "tilted_eval_launch"):
        getattr(lib, name).restype = ctypes.c_int
    lib.dense_level_error_string.argtypes = [ctypes.c_int]
    lib.dense_level_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dense_level_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _stream(dev: torch.device):
    return device_index(dev), torch.cuda.current_stream(dev).cuda_stream


def tilted_table(ii: torch.Tensor) -> torch.Tensor:
    """Sum table [B, H+1, W+1] int32 → the tilted table of the same image
    (``ops.integral.tilted_integral_image``), int32 of the same shape. A
    CUDA tensor launches the tilted-table kernel (counted in
    ``tilted_table.launches``) or raises; a CPU tensor runs the plain
    version, ``ops.integral.tilted_from_integral``."""
    if ii.dtype != torch.int32 or ii.ndim != 3 or min(ii.shape[1:]) < 2:
        raise TypeError(f"sum table must be [B, H+1, W+1] int32 with H, W "
                        f">= 1, got {ii.dtype} {tuple(ii.shape)}")
    if not ii.is_contiguous():
        raise ValueError("sum table must be contiguous")
    if ii.device.type == "cpu":
        return tilted_from_integral(ii)
    if ii.device.type != "cuda":
        raise ValueError(f"no tilted-table kernel for {ii.device}")
    B, H, W = ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1
    _check_frames(B)
    lib = _library()
    iit = torch.empty_like(ii)
    _raise_on(lib, lib.tilted_table_launch(
        *_stream(ii.device), ii.data_ptr(), B, H, W, iit.data_ptr()),
        "tilted_table")
    tilted_table.launches += 1
    return iit


def _tilted_eval(ii, sq, iit, plan: DenseLevelPlan):
    """The evaluation kernel on a level's three tables (CUDA tensors) →
    (vnf, alive); one launch, not counted (``dense_level_tilted`` counts
    its calls)."""
    l, tabs, B, dev = plan.level, plan.tables, ii.shape[0], ii.device
    for t in (ii, sq, iit):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B, l.sh + 1, l.sw + 1)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError("tables must be contiguous [B, sh+1, sw+1] "
                             "int32 on one device")
    _check_frames(B)
    lib = _library()
    n_ty, n_tx = plan.n_tiles
    vnf = torch.empty((B, l.ny, l.nx), dtype=torch.float32, device=dev)
    alive = torch.empty((B, l.ny, l.nx), dtype=torch.uint8, device=dev)
    _raise_on(lib, lib.tilted_eval_launch(
        *_stream(dev), ii.data_ptr(), sq.data_ptr(),
        iit.data_ptr(), B, l.sh, l.sw, l.ystep, l.nx, l.ny, plan.tile_ny,
        plan.tile_nx, n_ty, n_tx, tabs.window_h, tabs.window_w,
        plan.tile_rows, plan.pitch, plan.device_records(dev).data_ptr(),
        len(plan.records), tabs.device_tables(dev)["stage_thr"].data_ptr(),
        tabs.n_dense, tabs.norm_w, tabs.norm_h, tabs.norm_area, tabs.var_thr,
        plan.smem_bytes, vnf.data_ptr(), alive.data_ptr()), "tilted_eval")
    return vnf, alive


def dense_level_tilted(img: torch.Tensor, plan: DenseLevelPlan):
    """Level image [B,sh,sw] uint8 → (ii, iit [B,sh+1,sw+1] int32, vnf
    [B,ny,nx] float32, alive [B,ny,nx] uint8). On a CUDA tensor, in order on
    the current stream: ``integral_tables`` (counted there),
    ``tilted_table`` (counted there) and the tiled evaluation kernel
    (counted in ``dense_level_tilted.launches``, one per call); on a CPU
    tensor the plain version."""
    if not plan.tilted:
        raise ValueError("plan is for the strip kernel")
    _check_img(img, plan)
    if img.device.type == "cpu":
        return dense_level_reference(img, plan)
    if img.device.type != "cuda":
        raise ValueError(f"no dense level kernel for {img.device}")
    _check_frames(img.shape[0])
    ii, sq = integral_tables(img)
    iit = tilted_table(ii)
    vnf, alive = _tilted_eval(ii, sq, iit, plan)
    dense_level_tilted.launches += 1
    return ii, iit, vnf, alive


def dense_level_strips(img: torch.Tensor, plan: DenseLevelPlan):
    """Level image [B,sh,sw] uint8 → (vnf [B,ny,nx] float32, alive
    [B,ny,nx] uint8) with the row-strip kernel (counted in
    ``dense_level_strips.launches``) on a CUDA tensor, the plain version on
    a CPU tensor."""
    if plan.tilted:
        raise ValueError("plan is for the tilted kernels")
    _check_img(img, plan)
    if img.device.type == "cpu":
        return dense_level_reference(img, plan)[2:]
    if img.device.type != "cuda":
        raise ValueError(f"no dense level kernel for {img.device}")
    l, B, dev = plan.level, img.shape[0], img.device
    _check_frames(B)
    lib = _library()
    vnf = torch.empty((B, l.ny, l.nx), dtype=torch.float32, device=dev)
    alive = torch.empty((B, l.ny, l.nx), dtype=torch.uint8, device=dev)
    _raise_on(lib, lib.dense_strips_launch(
        *_stream(dev), img.data_ptr(), B, l.sh, l.sw, l.ystep, l.nx, l.ny,
        plan.strip_gy, plan.n_strips, plan.tables.window_h,
        *plan.tables.launch_args(dev), plan.smem_bytes, vnf.data_ptr(),
        alive.data_ptr()), "dense_strips")
    dense_level_strips.launches += 1
    return vnf, alive


dense_level_tilted.launches = 0
dense_level_strips.launches = 0
tilted_table.launches = 0
