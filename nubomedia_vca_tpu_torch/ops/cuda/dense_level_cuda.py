"""The dense phase of one pre-resized pyramid level: integral tables,
variance normalization and the cascade's dense block on the level's
ystep-strided window grid.

Port of the TPU kernel ``build_dense_phase``
(``nubomedia_vca_tpu/ops/pallas/dense_pallas.py:221``) in its two forms,
both launched from ``csrc/dense_level.cu``:

* ``dense_level_tilted`` — the single-block kernel with the tilted table
  (``pallas_call`` :329): one block per frame builds the sum, squared-sum
  and tilted tables of the whole level in shared memory and emits the sum
  and tilted tables for the survivor patch gather, with ``vnf`` and
  ``alive``;
* ``dense_level_strips`` — the row-strip kernel (``strip_kernel`` :276,
  ``pallas_call`` :300): non-tilted levels in strips of ``strip_gy``
  window rows with an (h0-1)-row halo, one block per (strip, frame); with
  one strip it is the non-tilted single block.

``DenseLevelPlan`` holds a level's geometry and strip plan;
``dense_level_reference`` is the plain PyTorch version of both forms (the
strip form builds strip-local tables, exactly as the kernel does). A
wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor, or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...cascade.pyramid import LevelSpec
from ..integral import integral_image, sq_integral_image, tilted_integral_image
from . import _build
from .dense_cuda import (CASCADE_ARGTYPES, MAX_GRID_Y, MAX_SMEM_BYTES,
                         DenseTables, device_index)


def tilted_smem_bytes(l: LevelSpec) -> int:
    """Shared memory of a level in the tilted kernel: sum, squared-sum and
    tilted tables, 4 B per element each."""
    return 3 * 4 * (l.sh + 1) * (l.sw + 1)


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
    """One level of one engine for the level kernel: tilted (one block per
    frame, the whole level) or row strips."""

    level: LevelSpec
    tables: DenseTables
    tilted: bool
    strip_gy: int       # window-origin rows per strip, a multiple of ystep
    n_strips: int
    smem_bytes: int

    @classmethod
    def make(cls, level: LevelSpec, tables: DenseTables, tilted: bool,
             max_smem: int = MAX_SMEM_BYTES) -> "DenseLevelPlan":
        """The level's plan; raises ValueError when its tables do not fit
        `max_smem` (tilted: the whole level; otherwise a one-row strip)."""
        h0 = tables.window_h
        if tilted:
            smem = tilted_smem_bytes(level)
            if smem > max_smem:
                raise ValueError(
                    f"tilted level {level.sw}x{level.sh} needs {smem} B of "
                    f"tables > {max_smem} B of shared memory")
            # one strip of every grid row (a multiple of ystep, like any
            # strip: the kernel counts a strip's grid rows as strip_gy/ystep)
            return cls(level, tables, True, level.ny * level.ystep, 1, smem)
        if tables.tilted:
            raise ValueError("the strip kernel takes non-tilted dense blocks")
        plan = strip_plan(level, h0, max_smem)
        if plan is None:
            raise ValueError(
                f"level {level.sw}x{level.sh} is too wide for a row strip "
                f"in {max_smem} B of shared memory")
        strip_gy, n_strips = plan
        rows = min(strip_gy + h0 - 1, level.sh)
        return cls(level, tables, False, strip_gy, n_strips,
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


# ------------------------------------------------------------ plain version
def dense_level_reference(img: torch.Tensor, plan: DenseLevelPlan):
    """Plain PyTorch version of both forms, on ``img``'s device → tilted:
    (ii, iit, vnf, alive); strips: (None, None, vnf, alive)."""
    _check_img(img, plan)
    l, tabs = plan.level, plan.tables
    if plan.tilted:
        ii, iit = integral_image(img), tilted_integral_image(img)
        vnf, alive = tabs.evaluate(ii, sq_integral_image(img), iit,
                                   l.ny, l.nx, l.ystep)
        return ii, iit, vnf, alive
    vnfs, alives = [], []
    for row0, rows, n_rows in plan.strips():
        x = img[:, row0:row0 + rows]
        vnf, alive = tabs.evaluate(integral_image(x), sq_integral_image(x),
                                   None, n_rows, l.nx, l.ystep)
        vnfs.append(vnf)
        alives.append(alive)
    return None, None, torch.cat(vnfs, 1), torch.cat(alives, 1)


# ------------------------------------------------------------------ kernel
def _check_img(img: torch.Tensor, plan: DenseLevelPlan) -> None:
    l = plan.level
    if img.dtype != torch.uint8:
        raise TypeError(f"level image must be uint8, got {img.dtype}")
    if img.ndim != 3 or tuple(img.shape[1:]) != (l.sh, l.sw):
        raise ValueError(f"level image must be [B, {l.sh}, {l.sw}], got "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("level image must be contiguous")


_P = ctypes.c_void_p
_I = ctypes.c_int
_LAUNCH_ARGTYPES = [
    _I, _P, _I,                  # device, stream, tilted
    _P, _I, _I, _I,              # img, B, sh, sw
    _I, _I, _I,                  # step, nx, ny
    _I, _I, _I,                  # strip_gy, n_strips, win_h
    *CASCADE_ARGTYPES,
    _I,                          # smem
    _P, _P, _P, _P,              # ii_out, iit_out, vnf_out, alive_out
]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("dense_level")
    lib.dense_level_launch.argtypes = _LAUNCH_ARGTYPES
    lib.dense_level_launch.restype = ctypes.c_int
    lib.dense_level_error_string.argtypes = [ctypes.c_int]
    lib.dense_level_error_string.restype = ctypes.c_char_p
    return lib


def _launch(img: torch.Tensor, plan: DenseLevelPlan):
    l, B, dev = plan.level, img.shape[0], img.device
    if not 1 <= B <= MAX_GRID_Y:
        raise ValueError(f"1 to {MAX_GRID_Y} frames per launch, got {B}")
    lib = _library()
    ii = iit = None
    if plan.tilted:
        ii = torch.empty((B, l.sh + 1, l.sw + 1), dtype=torch.int32,
                         device=dev)
        iit = torch.empty_like(ii)
    vnf = torch.empty((B, l.ny, l.nx), dtype=torch.float32, device=dev)
    alive = torch.empty((B, l.ny, l.nx), dtype=torch.uint8, device=dev)
    rc = lib.dense_level_launch(
        device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
        int(plan.tilted), img.data_ptr(), B, l.sh, l.sw, l.ystep, l.nx,
        l.ny, plan.strip_gy, plan.n_strips, plan.tables.window_h,
        *plan.tables.launch_args(dev), plan.smem_bytes,
        ii.data_ptr() if ii is not None else None,
        iit.data_ptr() if iit is not None else None,
        vnf.data_ptr(), alive.data_ptr())
    if rc != 0:
        msg = lib.dense_level_error_string(rc).decode()
        raise RuntimeError(f"dense_level kernel launch failed: {msg} ({rc})")
    return ii, iit, vnf, alive


def _dispatch(img: torch.Tensor, plan: DenseLevelPlan, counter):
    _check_img(img, plan)
    if img.device.type == "cpu":
        return dense_level_reference(img, plan)
    if img.device.type != "cuda":
        raise ValueError(f"no dense level kernel for {img.device}")
    out = _launch(img, plan)
    counter.launches += 1
    return out


def dense_level_tilted(img: torch.Tensor, plan: DenseLevelPlan):
    """Level image [B,sh,sw] uint8 → (ii, iit [B,sh+1,sw+1] int32, vnf
    [B,ny,nx] float32, alive [B,ny,nx] uint8) with the tilted kernel
    (counted in ``dense_level_tilted.launches``) on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not plan.tilted:
        raise ValueError("plan is for the strip kernel")
    return _dispatch(img, plan, dense_level_tilted)


def dense_level_strips(img: torch.Tensor, plan: DenseLevelPlan):
    """Level image [B,sh,sw] uint8 → (vnf [B,ny,nx] float32, alive
    [B,ny,nx] uint8) with the row-strip kernel (counted in
    ``dense_level_strips.launches``) on a CUDA tensor, the plain version on
    a CPU tensor."""
    if plan.tilted:
        raise ValueError("plan is for the tilted kernel")
    return _dispatch(img, plan, dense_level_strips)[2:]


dense_level_tilted.launches = 0
dense_level_strips.launches = 0
