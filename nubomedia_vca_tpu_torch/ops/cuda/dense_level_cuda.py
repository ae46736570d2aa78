"""The dense phase of one pre-resized tilted pyramid level: integral
tables, variance normalization and the cascade's dense block on the
level's ystep-strided window grid.

Port of the TPU kernel ``build_dense_phase``
(``nubomedia_vca_tpu/ops/pallas/dense_pallas.py:221``) in its tilted form
(``pallas_call`` :329), in ``csrc/dense_level.cu``; its row-strip form
(``strip_kernel`` :276) is a band of the pyramid kernel
(``dense_cuda.pyramid_dense_phase``).

``dense_level_tilted`` also emits the sum and tilted tables for the
survivor patch gather. A table pass in device memory, then a tiled
evaluation: the sum and squared-sum tables
(``integral_cuda.integral_tables``), the tilted table built from the sum
table (``tilted_table``), then one block per (tile, frame) that stages the
tile's window of the three tables in shared memory and evaluates its
``tile_ny`` x ``tile_nx`` strided windows. Shared memory is sized by the
tile, not by the level, so every level of a tilted cascade takes it.

``DenseLevelPlan`` holds a level's geometry and its tiles;
``dense_level_reference`` is the plain PyTorch version, which evaluates
tile by tile on the level's tables, exactly as the kernel cuts the level.
The wrapper runs the plain version for a CPU tensor and launches the
kernels for a CUDA tensor, or raises; it never falls back.
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
from .dense_cuda import (MAX_GRID_Y, MAX_SMEM_BYTES, TREE_WORDS, DenseTables,
                         device_index, tile_records)
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


@dataclasses.dataclass(frozen=True)
class DenseLevelPlan:
    """One tilted level of one engine for the level kernels: tiles of
    ``tile_ny`` x ``tile_nx`` strided windows, staged as ``tile_rows`` rows
    of ``pitch`` table entries, and the tree records for that pitch."""

    level: LevelSpec
    tables: DenseTables
    tile_ny: int        # strided windows per tile
    tile_nx: int
    tile_rows: int      # table rows and row length of a full tile
    pitch: int
    smem_bytes: int     # dynamic shared memory of one evaluation block
    records: np.ndarray = dataclasses.field(compare=False)
    _device: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @classmethod
    def make(cls, level: LevelSpec, tables: DenseTables,
             max_smem: int = MAX_SMEM_BYTES,
             tile: tuple[int, int] = TILE) -> "DenseLevelPlan":
        """The level's plan; raises ValueError when a tile and the tree
        records do not fit `max_smem` bytes of shared memory."""
        if not tilted_fits(level, tables, max_smem, tile):
            raise ValueError(
                f"tilted level {level.sw}x{level.sh}: a tile of "
                f"{tile[0]}x{tile[1]} windows needs "
                f"{tile_smem_bytes(level, tables, tile)} B > {max_smem} "
                "B of shared memory")
        rows, pitch = tile_shape(level, tables, tile)
        return cls(level, tables, tile[0], tile[1], rows, pitch,
                   tile_smem_bytes(level, tables, tile),
                   tile_records(tables, pitch))

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
    """Plain PyTorch version, on ``img``'s device → (ii, iit, vnf,
    alive)."""
    _check_img(img, plan)
    ii, iit = integral_image(img), tilted_integral_image(img)
    vnf, alive = _evaluate_tiles(plan, ii, sq_integral_image(img), iit)
    return ii, iit, vnf, alive


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
    for name in ("tilted_table_launch", "tilted_eval_launch"):
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


dense_level_tilted.launches = 0
tilted_table.launches = 0
