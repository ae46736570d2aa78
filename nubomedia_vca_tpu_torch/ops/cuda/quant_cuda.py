"""Dynamic per-tensor int8 quantization of activations.

Port of the TPU kernels ``quantize_int8_pallas`` and
``quantize_int8_stochastic_pallas``
(``nubomedia_vca_tpu/ops/pallas/quant_pallas.py:73``, ``:100``). The int8
learned detector (``models/quant.py``) quantizes every layer's input with
``quantize_int8``. A CUDA tensor launches ``csrc/quant_int8.cu`` (counted in
``quantize_int8.launches`` and ``quantize_int8_stochastic.launches``, once
per call: a call is two launches, a reduction and the quantizing pass) or
raises; a CPU tensor runs the plain version of ``ops/quant.py``. Unlike the
TPU kernel there is no size ceiling (its 1.5M-element limit was VMEM's),
and unlike the JAX function the stochastic quantizer never falls back to
deterministic rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import (MASK32, quantize_int8_reference,
                     quantize_int8_stochastic_reference)
from . import _build
from .dense_cuda import device_index


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("quant_int8")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.quant_int8_launch.argtypes = [I, P, P, ctypes.c_longlong, I,
                                      ctypes.c_uint, P, P, P]
    lib.quant_int8_launch.restype = ctypes.c_int
    lib.quant_int8_error_string.argtypes = [ctypes.c_int]
    lib.quant_int8_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if x.numel() == 0:
        raise ValueError("cannot quantize an empty tensor")
    if x.device.type != "cuda":
        raise ValueError(f"no quantization kernel for {x.device}")


def _launch(x: torch.Tensor, stochastic: bool, seed: int):
    lib = _library()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device)
    rc = lib.quant_int8_launch(
        device_index(x.device), torch.cuda.current_stream(x.device).cuda_stream,
        x.data_ptr(), x.numel(), int(stochastic), seed & MASK32,
        scratch.data_ptr(), q.data_ptr(), scale.data_ptr())
    if rc != 0:
        msg = lib.quant_int8_error_string(rc).decode()
        raise RuntimeError(f"quant_int8 kernel launch failed: {msg} ({rc})")
    return q, scale


def quantize_int8(x: torch.Tensor):
    """x float32 (any shape) → (values int8 of x's shape, scale float32
    scalar tensor): ``clip(rint(x / scale), ±127)``, ``scale =
    max(max|x|, 1e-8) / 127``."""
    if x.device.type == "cpu":
        return quantize_int8_reference(x)
    _check(x)
    out = _launch(x, False, 0)
    quantize_int8.launches += 1
    return out


def quantize_int8_stochastic(x: torch.Tensor, seed: int):
    """The same scale, with unbiased stochastic rounding from Philox4x32-10
    keyed by ``seed`` (see ``ops/quant.py``)."""
    if x.device.type == "cpu":
        return quantize_int8_stochastic_reference(x, seed)
    _check(x)
    out = _launch(x, True, int(seed))
    quantize_int8_stochastic.launches += 1
    return out


quantize_int8.launches = 0
quantize_int8_stochastic.launches = 0
