"""The port's int8 quantizers (``nubomedia_vca_tpu_torch/ops/quant.py``, the
plain versions of the CUDA kernels in ``csrc/quant_int8.cu``) against the
JAX package on the CPU, and the port's weight quantization
(``models/quant.quantize_params``).

Deterministic: bit for bit against ``quantize_int8_pallas`` in interpret
mode and ``quantize_int8_xla`` (beyond the Pallas kernel's 1.5M-element
ceiling). Stochastic: the JAX function falls back to deterministic
rounding off the TPU and the TPU's PRNG cannot be reproduced, so the port's
Philox4x32-10 rounding is held to its definition (each value is the floor
or the floor + 1 of ``x / scale``, a seed reproduces, another seed differs,
the mean error is zero within 5 sigma) and its generator to the Random123
known-answer vectors and a numpy uint32 mirror.

The CUDA kernel's work split and its epoch-tagged maximum slot are
mirrored in numpy: the groups a thread keeps in registers and the rest it
streams, then re-reads in reverse, cover every group of 4 elements once
per pass at the grid sizes the wrapper picks; the slot orders a call's
values above every earlier call's and is cleared when the epoch wraps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models import cnn as jcnn
from nubomedia_vca_tpu.models import quant as jquant
from nubomedia_vca_tpu.ops.pallas.quant_pallas import (quantize_int8_pallas,
                                                       quantize_int8_xla)
from nubomedia_vca_tpu_torch.models import quant as pquant
from nubomedia_vca_tpu_torch.ops import quant
from nubomedia_vca_tpu_torch.ops.cuda import quant_cuda

torch.set_num_threads(2)


def _assert_same(got, want):
    q, s = got
    wq, ws = (np.asarray(v) for v in want)
    assert q.dtype == torch.int8 and q.shape == wq.shape
    np.testing.assert_array_equal(q.numpy(), wq)
    assert s.dtype == torch.float32 and s.ndim == 0
    assert s.item() == ws.item()


@pytest.mark.parametrize("shape,gain", [((64, 128), 3.7), ((3, 5, 7), 1e-3),
                                        ((2, 9, 11, 1), 250.0)])
def test_plain_quantizer_equals_pallas_interpret(shape, gain):
    x = (np.random.RandomState(sum(shape)).randn(*shape) * gain).astype(
        np.float32)
    want = quantize_int8_pallas(jnp.asarray(x), interpret=True)
    _assert_same(quant.quantize_int8_reference(torch.from_numpy(x)), want)


def test_plain_quantizer_equals_xla_beyond_pallas_ceiling():
    """1.6M elements, over the Pallas kernel's 1.5M VMEM ceiling: the JAX
    package takes quantize_int8_xla there; values at x.5 steps too."""
    rng = np.random.RandomState(3)
    x = rng.randn(1_600_003).astype(np.float32) * 2.0
    x[:1000] = (np.arange(1000, dtype=np.float32) - 500.0) * 0.25
    x[1000] = 127.0 * 0.25     # the abs-max: x / scale hits halves exactly
    want = jax.jit(quantize_int8_xla)(jnp.asarray(x))
    got = quant.quantize_int8_reference(torch.from_numpy(x))
    _assert_same(got, want)
    assert np.abs(got[0].numpy()).max() == 127


def test_all_zero_tensor_takes_the_floor_scale():
    x = np.zeros((4, 33), np.float32)
    got = quant.quantize_int8_reference(torch.from_numpy(x))
    _assert_same(got, jax.jit(quantize_int8_xla)(jnp.asarray(x)))
    assert got[1].item() == np.float32(1e-8) * np.float32(1.0 / 127.0)


def test_wrappers_run_the_plain_version_on_cpu():
    x = torch.from_numpy(np.random.RandomState(4).randn(7, 13).astype(
        np.float32))
    before = (quant_cuda.quantize_int8.launches,
              quant_cuda.quantize_int8_stochastic.launches)
    for got, want in ((quant_cuda.quantize_int8(x),
                       quant.quantize_int8_reference(x)),
                      (quant_cuda.quantize_int8_stochastic(x, 9),
                       quant.quantize_int8_stochastic_reference(x, 9))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (quant_cuda.quantize_int8.launches,
            quant_cuda.quantize_int8_stochastic.launches) == before
    with pytest.raises(TypeError):
        quant_cuda.quantize_int8(x.double())
    with pytest.raises(ValueError):
        quant_cuda.quantize_int8(torch.zeros(0))


# ------------------------------------------------------- kernel mirrors
# the seven layer inputs of a B=64 720p int8 forward (320x240 canvas)
LAYER_SIZES = (4_915_200, 19_660_800, 9_830_400, 4_915_200, 2_457_600,
               2_457_600, 4_915_200)


def _partition_mirror(n: int, blocks: int):
    """numpy mirror of quant_kernel's loops for n elements on `blocks`
    blocks → per group of 4 elements: times read into registers, times
    streamed in pass 1, times quantized in pass 2, and whether each
    thread's pass 2 runs its pass 1 backwards."""
    K, T = quant_cuda.REG_GROUPS, blocks * quant_cuda.THREADS
    G = -(-n // 4)
    t = np.arange(T, dtype=np.int64)
    reg, one, two = (np.zeros(G, np.int64) for _ in range(3))
    for k in range(K):                      # registers
        g = k * T + t
        np.add.at(reg, g[g < G], 1)
    first = K * T + t
    last = first - T
    step1, step2 = np.full(G, -1, np.int64), np.full(G, -1, np.int64)
    g, i = first.copy(), 0
    while (g < G).any():                    # pass 1, forward
        on = g < G
        np.add.at(one, g[on], 1)
        step1[g[on]] = i
        last[on] = g[on]
        g, i = g + T, i + 1
    n_steps = np.where(last >= first, (last - first) // T + 1, 0)
    g, j = last.copy(), 0
    while (g >= first).any():               # pass 2, backward
        on = g >= first
        np.add.at(two, g[on], 1)
        step2[g[on]] = n_steps[on] - 1 - j
        g, j = g - T, j + 1
    return reg, one, two, bool(np.array_equal(step1, step2))


@pytest.mark.parametrize("n", [1, 1023, 1025, 2**24 + 3, *LAYER_SIZES])
def test_kernel_partition_covers_every_group_once(n):
    """At the wrapper's grid for 528, 660 and 1056 resident blocks (4, 5
    and 8 blocks on 132 SMs) and at 1 and 7 blocks: the groups kept in
    registers and the streamed ones cover every group once in the maximum
    pass and once in the quantizing pass, which walks each thread's
    streamed groups backwards; only inputs past the registers' reach are
    streamed."""
    G = -(-n // 4)
    grids = {quant_cuda.launch_blocks(n, most) for most in (528, 660, 1056)}
    for blocks in sorted(grids | {1, 7}):
        reg, one, two, reverse = _partition_mirror(n, blocks)
        assert ((reg + one) == 1).all() and ((reg + two) == 1).all()
        assert reverse
        held = quant_cuda.REG_GROUPS * quant_cuda.THREADS * blocks
        assert one.sum() == max(0, G - held)
    assert quant_cuda.launch_blocks(n, 660) == min(
        660, -(-G // (quant_cuda.REG_GROUPS * quant_cuda.THREADS)))


def test_max_slot_epochs_order_and_wrap():
    """The slot word (epoch << 32) | bits: a call's smallest value beats an
    earlier call's largest, and within a call the largest |x| wins (a NaN
    above infinity); at the 32-bit epoch's end the slot is zeroed and the
    epochs start again at 1."""
    slot = quant_cuda.MaxSlot(torch.device("cpu"))

    def word(epoch, v):
        return (epoch << 32) | int(np.float32(abs(v)).view(np.uint32))

    assert word(2, 0.0) > word(1, np.inf)
    assert word(1, np.nan) > word(1, np.inf) > word(1, 3.0) > word(1, 1e-9)
    assert [slot.take()[1] for _ in range(3)] == [1, 2, 3]
    slot.slot.fill_(word(3, 5.0) - (1 << 63))     # as the int64 holds it
    slot.epoch = quant_cuda.EPOCHS - 2
    ptr, epoch = slot.take()
    assert epoch == quant_cuda.EPOCHS - 1 and slot.slot.item() != 0
    assert ptr == slot.slot.data_ptr()
    assert slot.take()[1] == 1 and slot.slot.item() == 0


# ---------------------------------------------------------------- Philox
def _philox_np(ctr: np.ndarray, key: tuple[int, int]):
    """Philox4x32-10 in numpy uint32/uint64, counters (c, 0, 0, 0)."""
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    c0 = ctr.astype(np.uint32)
    c1 = np.zeros_like(c0)
    c2 = np.zeros_like(c0)
    c3 = np.zeros_like(c0)
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    for r in range(10):
        if r:
            k0 = np.uint32((int(k0) + 0x9E3779B9) & 0xFFFFFFFF)
            k1 = np.uint32((int(k1) + 0xBB67AE85) & 0xFFFFFFFF)
        p0 = m0 * c0.astype(np.uint64)
        p1 = m1 * c2.astype(np.uint64)
        hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), p0.astype(np.uint32)
        hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), p1.astype(np.uint32)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))])
def test_philox_known_answers(counter, key, want):
    """The Random123 known-answer vectors of Philox4x32-10."""
    got = quant.philox4x32_10([torch.tensor(c) for c in counter], key)
    assert tuple(int(v) for v in got) == want


def test_philox_equals_numpy_mirror():
    ctr = np.concatenate([np.arange(5000), [2**32 - 1, 2**31, 12345678]])
    for seed in (0, 1, 2**31 - 1, -5):
        got = quant.philox4x32_10(
            (torch.from_numpy(ctr.astype(np.int64)), 0, 0, 0), (seed, 0))
        want = _philox_np(ctr, (seed & 0xFFFFFFFF, 0))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_uniform24_takes_word_i_mod_4_of_counter_i_div_4():
    u = quant.uniform24(10, 17, "cpu")
    words = _philox_np(np.arange(3), (17, 0))
    want = np.stack(words, -1).reshape(-1)[:10] >> np.uint32(8)
    np.testing.assert_array_equal(u.numpy(), want.astype(np.float32)
                                  * np.float32(2.0 ** -24))
    assert u.dtype == torch.float32 and 0.0 <= u.min() and u.max() < 1.0


# ----------------------------------------------------- stochastic rounding
def test_stochastic_rounding_is_floor_or_ceil_and_unbiased():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(200_001).astype(np.float32) * 0.7)
    q, s = quant.quantize_int8_stochastic_reference(x, 123)
    assert s.item() == quant.quantize_int8_reference(x)[1].item()
    r = (x / s).clamp(-127, 127)
    lo = torch.floor(r)
    qf = q.to(torch.float32)
    assert bool(((qf == lo) | (qf == lo + 1)).all())
    # the same seed reproduces, another seed differs
    assert torch.equal(q, quant.quantize_int8_stochastic_reference(x, 123)[0])
    other = quant.quantize_int8_stochastic_reference(x, 124)[0]
    assert int((other != q).sum()) > 1000
    # unbiased: E[q - x/scale] = 0; each term has variance f(1-f) <= 1/4
    err = (qf - r).double()
    frac = (r - lo).double()
    sigma = float(torch.sqrt((frac * (1 - frac)).sum())) / err.numel()
    assert abs(float(err.mean())) <= 5 * sigma
    # the probability of rounding up is the fractional part
    up = (qf == lo + 1).double()
    mid = (frac > 0.2) & (frac < 0.8)
    assert abs(float((up - frac)[mid].mean())) < 0.01


# ------------------------------------------------------------ weights
@pytest.mark.parametrize("which", ["checkpoint", "narrow"])
def test_quantize_params_equals_jax(which):
    if which == "checkpoint":
        jparams = jcnn.load_params_npz(jcnn.find_checkpoint())
    else:
        jparams = jcnn.init_params(jax.random.PRNGKey(1), channels=(4, 8, 8, 16),
                                   head_dim=16, ctx=True)
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    want = jquant.quantize_params(jparams)
    got = pquant.quantize_params(nparams)
    assert list(got) == list(want)
    for name in want:
        for f in ("w_q", "w_s", "b"):
            w, g = np.asarray(want[name][f]), got[name][f]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, f)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}/{f}")
    assert pquant.size_report(nparams) == jquant.size_report(jparams)
