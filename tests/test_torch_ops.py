"""Parity of the PyTorch port's image ops with the JAX package on the CPU:
exact INTER_LINEAR_EXACT resize, equalizeHist, integral tables and
minNeighbors grouping. Inputs are made from a seed with numpy and handed to
both; every comparison is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.ops import grouping as jgrouping
from nubomedia_vca_tpu.ops.histogram import equalize_hist as j_equalize
from nubomedia_vca_tpu.ops.integral import (integral_image as j_ii,
                                            sq_integral_image as j_sq)
from nubomedia_vca_tpu.ops.resize import resize_linear_exact as j_resize
from nubomedia_vca_tpu_torch.ops import grouping
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.integral import (integral_image,
                                                  sq_integral_image)
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact

torch.set_num_threads(2)


def _u8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


@pytest.mark.parametrize("src_hw,dst_wh", [
    ((720, 1280), (160, 90)),     # 720p → main-path work image
    ((480, 640), (160, 120)),
    ((90, 160), (128, 72)),       # pyramid levels of the 160x90 work image
    ((90, 160), (42, 24)),
    ((33, 47), (13, 9)),          # odd shapes, down and up
    ((61, 97), (150, 80)),
    ((90, 160), (160, 90)),       # identity
])
def test_resize_matches_jax(src_hw, dst_wh):
    img = _u8(sum(src_hw + dst_wh), (2,) + src_hw)
    got = resize_linear_exact(torch.from_numpy(img), dst_wh)
    want = np.asarray(j_resize(jnp.asarray(img), dst_wh))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(90, 160), (120, 160), (37, 53)])
def test_equalize_matches_jax(hw):
    rng = np.random.RandomState(7)
    imgs = np.stack([
        rng.randint(0, 256, hw),
        rng.randint(90, 140, hw),                  # narrow histogram
        np.full(hw, 77),                           # constant: passthrough
        np.where(rng.rand(*hw) < 0.3, 12, 200),    # two values
    ]).astype(np.uint8)
    got = equalize_hist(torch.from_numpy(imgs))
    want = np.asarray(j_equalize(jnp.asarray(imgs)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[2], imgs[2])


@pytest.mark.parametrize("hw", [(90, 160), (24, 42), (37, 53)])
def test_integral_tables_match_jax(hw):
    img = _u8(3, (2,) + hw)
    for port, ref in ((integral_image, j_ii), (sq_integral_image, j_sq)):
        got = port(torch.from_numpy(img))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(ref(jnp.asarray(img))))


def _rect_sets(seed, B, n):
    """B padded candidate sets: jittered clusters of detections (what the
    cascade emits around a face) plus isolated boxes, random valid mask."""
    rng = np.random.RandomState(seed)
    rects = np.zeros((B, n, 4), np.int32)
    valid = np.zeros((B, n), bool)
    for b in range(B):
        k = 0
        for _ in range(rng.randint(1, 6)):
            cx, cy, s = rng.randint(0, 140), rng.randint(0, 80), rng.randint(20, 60)
            for _ in range(rng.randint(1, 9)):
                if k == n:
                    break
                j = rng.randint(-3, 4, 3)
                rects[b, k] = (cx + j[0], cy + j[1], s + j[2], s + j[2])
                valid[b, k] = True
                k += 1
        m = rng.randint(0, n - k + 1)
        rects[b, k:k + m] = np.stack([rng.randint(0, 140, m),
                                      rng.randint(0, 80, m),
                                      rng.randint(20, 60, m),
                                      rng.randint(20, 60, m)], 1)
        valid[b, k:k + m] = rng.rand(m) < 0.7
        perm = rng.permutation(n)
        rects[b], valid[b] = rects[b, perm], valid[b, perm]
    return rects, valid


@pytest.mark.parametrize("n,thr", [(64, 3), (64, 0), (256, 1), (256, 3)])
def test_group_rectangles_torch_matches_jax(n, thr):
    rects, valid = _rect_sets(n + thr, 4, n)
    want = jax.vmap(lambda r, v: jgrouping.group_rectangles_jax(r, v, thr))(
        jnp.asarray(rects), jnp.asarray(valid))
    got = grouping.group_rectangles_torch(
        torch.from_numpy(rects), torch.from_numpy(valid), thr)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[1].any()


def test_group_rectangles_np_matches_jax_package():
    rects, valid = _rect_sets(11, 6, 48)
    for b in range(rects.shape[0]):
        for thr in (0, 2):
            r = rects[b][valid[b]]
            got = grouping.group_rectangles_np(r, thr, return_weights=True)
            want = jgrouping.group_rectangles_np(r, thr, return_weights=True)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
