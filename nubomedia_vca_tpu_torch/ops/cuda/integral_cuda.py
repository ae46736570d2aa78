"""Sum and squared-sum integral tables in one pass.

Port of the TPU kernel ``integral_images_pallas``
(``nubomedia_vca_tpu/ops/pallas/integral_pallas.py:52``). The tilted
dense phase (``dense_level_cuda.dense_level_tilted``) runs it first on
every level of a tilted cascade: its table pass. ``integral_tables`` launches
``csrc/integral_tables.cu`` for a CUDA tensor (or raises) and runs the
plain version, ``integral_image`` + ``sq_integral_image``, for a CPU
tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..integral import integral_image, sq_integral_image
from . import _build
from .dense_cuda import device_index


def integral_tables_reference(img: torch.Tensor):
    """[B,H,W] uint8 → (ii, sq) [B,H+1,W+1] int32, plain PyTorch."""
    return integral_image(img), sq_integral_image(img)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("integral_tables")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.integral_tables_launch.argtypes = [I, P, P, I, I, I, P, P]
    lib.integral_tables_launch.restype = ctypes.c_int
    lib.integral_tables_error_string.argtypes = [ctypes.c_int]
    lib.integral_tables_error_string.restype = ctypes.c_char_p
    return lib


def integral_tables(img: torch.Tensor):
    """[B,H,W] uint8 → (ii, sq) [B,H+1,W+1] int32 (squared sums wrap
    around). A CUDA tensor launches the kernel (counted in
    ``integral_tables.launches``) or raises."""
    if img.dtype != torch.uint8 or img.ndim != 3:
        raise TypeError(f"image must be [B,H,W] uint8, got {img.dtype} "
                        f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("image must be contiguous")
    if img.device.type == "cpu":
        return integral_tables_reference(img)
    if img.device.type != "cuda":
        raise ValueError(f"no integral kernel for {img.device}")
    B, H, W = img.shape
    if B < 1:
        raise ValueError("no frame to launch on")
    lib = _library()
    ii = torch.empty((B, H + 1, W + 1), dtype=torch.int32, device=img.device)
    sq = torch.empty_like(ii)
    rc = lib.integral_tables_launch(
        device_index(img.device),
        torch.cuda.current_stream(img.device).cuda_stream,
        img.data_ptr(), B, H, W, ii.data_ptr(), sq.data_ptr())
    if rc != 0:
        msg = lib.integral_tables_error_string(rc).decode()
        raise RuntimeError(f"integral_tables kernel launch failed: {msg} "
                           f"({rc})")
    integral_tables.launches += 1
    return ii, sq


integral_tables.launches = 0
