"""Dynamic per-tensor int8 quantization of activations.

Port of the TPU kernels ``quantize_int8_pallas`` and
``quantize_int8_stochastic_pallas``
(``nubomedia_vca_tpu/ops/pallas/quant_pallas.py:73``, ``:100``). The int8
learned detector (``models/quant.py``) quantizes every layer's input with
``quantize_int8``. A CUDA tensor launches ``csrc/quant_int8.cu`` (counted in
``quantize_int8.launches`` and ``quantize_int8_stochastic.launches``, one
launch per call: a cooperative launch with a grid-wide barrier between the
maximum and the quantizing pass) or raises; a CPU tensor runs the plain
version of ``ops/quant.py``. Unlike the TPU kernel there is no size ceiling
(its 1.5M-element limit was VMEM's), and unlike the JAX function the
stochastic quantizer never falls back to deterministic rounding.

The kernel's grid is ``launch_blocks``: enough blocks that every thread
keeps REG_GROUPS groups of 4 elements in registers, at most as many as the
device runs at once (asked once per device). Its running maximum lives in a
``MaxSlot`` per device and stream, tagged with a new epoch per call, so
nothing is cleared or allocated per call but the outputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import (MASK32, quantize_int8_reference,
                     quantize_int8_stochastic_reference)
from . import _build
from .dense_cuda import device_index

THREADS = 256      # threads a block (kThreads in csrc/quant_int8.cu)
REG_GROUPS = 8     # groups of 4 elements a thread keeps (kRegGroups)
EPOCHS = 1 << 32   # slot word = epoch << 32 | max bits


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("quant_int8")
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.quant_int8_launch.argtypes = [I, P, P, ctypes.c_longlong, I, U, I, P,
                                      U, P, P]
    lib.quant_int8_launch.restype = ctypes.c_int
    lib.quant_int8_max_blocks.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    lib.quant_int8_max_blocks.restype = ctypes.c_int
    lib.quant_int8_error_string.argtypes = [ctypes.c_int]
    lib.quant_int8_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int) -> None:
    if rc != 0:
        msg = lib.quant_int8_error_string(rc).decode()
        raise RuntimeError(f"quant_int8 kernel launch failed: {msg} ({rc})")


@functools.cache
def max_blocks(device: int) -> int:
    """The most blocks of the kernel that `device` runs at once."""
    lib = _library()
    out = ctypes.c_int(0)
    _raise_on(lib, lib.quant_int8_max_blocks(device, ctypes.byref(out)))
    return out.value


def launch_blocks(n: int, most: int) -> int:
    """Blocks for n elements: one per THREADS * REG_GROUPS groups of 4, at
    least 1 and at most `most`. Thread t of T keeps groups k * T + t
    (k < REG_GROUPS) and streams groups REG_GROUPS * T + t + i * T."""
    per_block = THREADS * REG_GROUPS
    return max(1, min(most, -(-(-(-n // 4)) // per_block)))


class MaxSlot:
    """The kernel's running maximum on one device and stream: one 64-bit
    word, (epoch << 32) | the bits of max|x|. ``take`` returns the slot's
    address and a new epoch for a call; a call's values exceed every value
    of the calls before it, so the slot is only cleared when the 32-bit
    epoch wraps."""

    def __init__(self, device: torch.device):
        self.slot = torch.zeros(1, dtype=torch.int64, device=device)
        self.epoch = 0

    def take(self) -> tuple[int, int]:
        self.epoch += 1
        if self.epoch == EPOCHS:
            self.slot.zero_()
            self.epoch = 1
        return self.slot.data_ptr(), self.epoch


_SLOTS: dict[tuple[int, int], MaxSlot] = {}


def _slot(dev: torch.device, stream: int) -> MaxSlot:
    key = (device_index(dev), stream)
    s = _SLOTS.get(key)
    if s is None:
        s = _SLOTS[key] = MaxSlot(torch.device("cuda", key[0]))
    return s


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
    dev = device_index(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    slot, epoch = _slot(x.device, stream).take()
    _raise_on(lib, lib.quant_int8_launch(
        dev, stream, x.data_ptr(), x.numel(), int(stochastic), seed & MASK32,
        launch_blocks(x.numel(), max_blocks(dev)), slot, epoch, q.data_ptr(),
        scale.data_ptr()))
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
