"""Dynamic per-tensor symmetric int8 quantization, plain PyTorch.

The plain versions of the TPU kernels ``quantize_int8_pallas`` and
``quantize_int8_stochastic_pallas``
(``nubomedia_vca_tpu/ops/pallas/quant_pallas.py:73``, ``:100``), which the
CUDA kernels of ``csrc/quant_int8.cu`` (wrappers in
``ops/cuda/quant_cuda.py``) equal bit for bit:

* ``quantize_int8_reference``: ``scale = max(max|x|, 1e-8) / 127`` and
  ``q = clip(rint(x / scale), -127, 127)``, with round-half-even — the
  Pallas kernel's body and ``quantize_int8_xla`` as XLA compiles them: the
  scale is a multiply by float32(1/127), ``x / scale`` a true division;
* ``quantize_int8_stochastic_reference``: the same scale, then
  ``q = clip(floor(clip(x / scale, ±127) + u), ±127)``. The TPU draws ``u``
  from its own PRNG, which nothing else reproduces; here element ``i``
  takes word ``i % 4`` of Philox4x32-10 (Salmon et al., SC'11) at counter
  ``(i // 4, 0, 0, 0)`` with key ``(seed, 0)``, and ``u`` is its top 24
  bits times 2^-24, as in the Pallas kernel.

``philox4x32_10`` computes the generator in int64 tensors holding 32-bit
words, so it runs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U24 = 1.0 / (1 << 24)
# XLA rewrites the division by the constant 127 into a multiply by its
# float32 reciprocal (it keeps x / scale a division)
RECIP_127 = float(np.float32(1.0 / 127.0))


def _scale(x: torch.Tensor) -> torch.Tensor:
    """max(max|x|, 1e-8) / 127 as a float32 scalar tensor on x's device,
    computed as XLA compiles it: a multiply by float32(1/127)."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("cannot quantize an empty tensor")
    return torch.clamp(x.abs().amax(), min=1e-8) * RECIP_127


def quantize_int8_reference(x: torch.Tensor):
    """x float32 (any shape) → (values int8, same shape; scale float32
    scalar tensor)."""
    scale = _scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * c, for a 32-bit
    constant m and 32-bit words c, without int64 overflow: c is split into
    16-bit halves."""
    p_lo = m * (c & 0xFFFF)                  # < 2^48
    p_hi = m * (c >> 16)                     # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)     # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 → its four 32-bit output words.

    counter: four int64 tensors (broadcastable) of 32-bit words; key: two
    Python ints. Words are returned as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & MASK32
                      for c in counter)
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & MASK32
            k1 = (k1 + _PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform24(n: int, seed: int, device) -> torch.Tensor:
    """The stochastic quantizer's u for elements 0..n-1: float32 in
    [0, 1), the top 24 bits of word i % 4 at counter i // 4."""
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_10((ctr, zero, zero, zero),
                                      (int(seed), 0)), dim=-1)
    return (words.reshape(-1)[:n] >> 8).to(torch.float32) * _U24


def quantize_int8_stochastic_reference(x: torch.Tensor, seed: int):
    """x float32 (any shape), int seed → (values int8, same shape; scale
    float32 scalar tensor), rounding down or up at random with the
    probability that makes the rounding unbiased."""
    scale = _scale(x)
    scaled = torch.clamp(x / scale, -127.0, 127.0)
    u = uniform24(x.numel(), seed, x.device).reshape(x.shape)
    q = torch.clamp(torch.floor(scaled + u), -127, 127).to(torch.int8)
    return q, scale
