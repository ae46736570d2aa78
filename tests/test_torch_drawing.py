"""The PyTorch port's overlay ops, color conversions and box helpers
against the JAX package on the CPU.

Drawing: rectangles and circles equal jitted JAX and the numpy twins
exactly (boxes past the frame edges, empty and invalid slots included).
The blend uses partial alphas (1..254 as well as 0 and 255) and equals
jitted JAX exactly; XLA:CPU multiplies by float32(1/255) and fuses
``acc * (1 - alpha) + rgb * alpha`` into one FMA, which the numpy twin
does not, so on a frame where the two differ the port follows jitted JAX
and the twin stays within 1 of it in every value. ``yuv420_to_bgr`` has no
FMA in the jitted program and equals it exactly, as do the integer gray
conversions and the box helpers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.api import render as jax_render
from nubomedia_vca_tpu.core import boxes as jax_boxes
from nubomedia_vca_tpu.ops import color as jax_color
from nubomedia_vca_tpu.ops import drawing as jax_drawing
from nubomedia_vca_tpu_torch.api import render
from nubomedia_vca_tpu_torch.core import boxes
from nubomedia_vca_tpu_torch.ops import color, drawing

torch.set_num_threads(2)

B, H, W, K = 4, 120, 160, 8
BLEND_ARGS = (0.1, -0.2, 1.3, 0.9)   # offset x/y, width, height (fractions)


def _box_set(seed):
    """Boxes past every edge, a zero-size one, and invalid slots."""
    rng = np.random.RandomState(seed)
    bx = np.stack([rng.randint(-20, W, (B, K)), rng.randint(-20, H, (B, K)),
                   rng.randint(0, 90, (B, K)), rng.randint(0, 70, (B, K))],
                  -1).astype(np.int32)
    bx[0, 0] = (W - 10, H - 10, 40, 40)
    bx[1, 1] = (5, 5, 0, 0)
    valid = rng.rand(B, K) < 0.7
    valid[:, K - 1] = False                 # a slot no frame uses
    return bx, valid


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    bgr = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    overlay = rng.randint(0, 256, (23, 17, 4)).astype(np.uint8)
    overlay[..., 3] = rng.randint(1, 255, (23, 17))   # partial alphas
    overlay[0, :, 3] = 0
    overlay[-1, :, 3] = 255
    return bgr, overlay, _box_set(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("fn", ["draw_rectangles", "draw_circles"])
@pytest.mark.parametrize("gray", [False, True])
def test_draw_matches_jitted_jax_and_twin(scene, fn, gray):
    bgr, _, (bx, valid) = scene
    img = bgr[..., 1] if gray else bgr
    color_ = (10, 200, 30)
    got = getattr(drawing, fn)(_t(img), _t(bx), _t(valid), color_, 3).numpy()
    want = np.asarray(jax.jit(getattr(jax_drawing, fn), static_argnums=(3, 4))(
        jnp.asarray(img), jnp.asarray(bx), jnp.asarray(valid), color_, 3))
    twin = getattr(drawing, fn + "_np")(img, bx, valid, color_, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(got, twin)
    assert (got != img).any()


# (acc, rgb1, alpha1, rgb2, alpha2): a pixel blended twice, where the
# jitted program's result and the twin's round to neighbouring values
# (found by a search over 2e7 random tuples, 27 hits)
TIES = [(242, 64, 76, 171, 49), (120, 47, 67, 181, 158),
        (229, 156, 147, 50, 79), (60, 193, 247, 73, 113),
        (197, 175, 32, 53, 23), (69, 208, 106, 209, 148),
        (79, 87, 121, 112, 76), (86, 219, 208, 230, 36)]


def _jit_blend(img, overlay, bx, valid, args):
    return np.asarray(jax.jit(jax_drawing.blend_overlay_image,
                              static_argnums=(4, 5, 6, 7))(
        jnp.asarray(img), jnp.asarray(overlay), jnp.asarray(bx),
        jnp.asarray(valid), *args))


def test_blend_matches_jitted_jax(scene):
    """Partial alphas on overlapping, edge-crossing boxes: the port equals
    jitted JAX in every value, and the numpy twin (a true division by 255,
    no FMA) stays within 1 of it."""
    bgr, overlay, _ = scene
    # large overlapping boxes, so that many pixels take several blends
    rng = np.random.RandomState(2)
    bx = np.stack([rng.randint(-10, W // 2, (B, K)),
                   rng.randint(-10, H // 2, (B, K)),
                   rng.randint(W // 3, W, (B, K)),
                   rng.randint(H // 3, H, (B, K))], -1).astype(np.int32)
    valid = np.ones((B, K), bool)
    valid[2, 3] = False
    got = drawing.blend_overlay_image(_t(bgr), _t(overlay), _t(bx),
                                      _t(valid), *BLEND_ARGS).numpy()
    assert np.array_equal(got, _jit_blend(bgr, overlay, bx, valid,
                                          BLEND_ARGS))
    twin = drawing.blend_overlay_image_np(bgr, overlay, bx, valid,
                                          *BLEND_ARGS)
    assert np.abs(got.astype(np.int16) - twin).max() <= 1
    assert (got != bgr).mean() > 0.3


def test_blend_follows_jitted_jax_where_the_twin_rounds_apart():
    """One row of 8 pixels, each blended by two boxes (texel x, then texel
    x + 8) from the tuples of TIES: the port equals jitted JAX, and the
    twin is 1 away in every value."""
    n = len(TIES)
    t = np.asarray(TIES, np.uint8)
    img = np.repeat(t[:, 0:1], 3, 1)[None, None]              # [1,1,n,3]
    overlay = np.zeros((1, 2 * n, 4), np.uint8)
    overlay[0, :n, :3], overlay[0, :n, 3] = t[:, 1:2], t[:, 2]
    overlay[0, n:, :3], overlay[0, n:, 3] = t[:, 3:4], t[:, 4]
    bx = np.array([[[0, 0, 2 * n, 1], [-n, 0, 2 * n, 1]]], np.int32)
    valid = np.ones((1, 2), bool)
    args = (0.0, 0.0, 1.0, 1.0)
    got = drawing.blend_overlay_image(_t(img), _t(overlay), _t(bx),
                                      _t(valid), *args).numpy()
    want = _jit_blend(img, overlay, bx, valid, args)
    assert np.array_equal(got, want)
    assert want[0, 0, :, 0].tolist() == [185, 151, 145, 138, 181, 175, 92,
                                         199]
    twin = drawing.blend_overlay_image_np(img, overlay, bx, valid, *args)
    assert (np.abs(got.astype(np.int16) - twin) == 1).all()


@pytest.mark.parametrize("mode", ["rect", "circle", "overlay"])
@pytest.mark.parametrize("gray", [False, True])
def test_render_detections_matches_jax(scene, mode, gray):
    bgr, overlay, (bx, valid) = scene
    frames = bgr[..., 0] if gray else bgr
    rects = [[tuple(b) for b, v in zip(bx[i], valid[i]) if v]
             for i in range(B)]
    kw = dict(mode=mode, color=(0, 0, 255), capacity=K)
    if mode == "overlay":
        kw["overlay"] = (overlay, BLEND_ARGS)
    got = render.render_detections(frames, rects, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(jax_render.render_detections(frames, rects, **kw))
    assert np.array_equal(got.numpy(), want)
    host = render.render_detections(frames, rects, host=True, **kw)
    assert isinstance(host, np.ndarray)
    assert np.array_equal(host, jax_render.render_detections(
        frames, rects, host=True, **kw))
    if mode != "overlay":
        assert np.array_equal(host, got.numpy())
    # a tensor stays on its device; one [H,W] gray frame is squeezed in
    # and out
    one = _t(frames[:1] if not gray else frames[0])
    one = render.render_detections(one, rects[:1], **kw)
    assert isinstance(one, torch.Tensor)
    assert np.array_equal(one.numpy().reshape(want[0].shape), want[0])


def test_color_conversions_match_jitted_jax():
    rng = np.random.RandomState(3)
    bgra = rng.randint(0, 256, (2, 37, 53, 4)).astype(np.uint8)
    for name, x in (("bgr_to_gray", bgra[..., :3]), ("rgb_to_gray",
                                                     bgra[..., :3]),
                    ("bgra_to_gray", bgra)):
        got = getattr(color, name)(_t(x)).numpy()
        want = np.asarray(jax.jit(getattr(jax_color, name))(jnp.asarray(x)))
        assert got.dtype == np.uint8 and np.array_equal(got, want), name
    y = rng.randint(0, 256, (3, 96, 128)).astype(np.uint8)
    u, v = (rng.randint(0, 256, (3, 48, 64)).astype(np.uint8)
            for _ in range(2))
    got = color.yuv420_to_bgr(_t(y), _t(u), _t(v)).numpy()
    want = np.asarray(jax.jit(jax_color.yuv420_to_bgr)(y, u, v))
    assert np.array_equal(got, want)
    assert np.array_equal(color.i420_luma(_t(y)).numpy(), y)


def test_boxes_match_jax():
    rng = np.random.RandomState(4)
    a = np.stack([rng.randint(-5, 50, 7), rng.randint(-5, 50, 7),
                  rng.randint(0, 40, 7), rng.randint(0, 40, 7)],
                 -1).astype(np.int32)
    b = np.concatenate([a[:2], np.stack(
        [rng.randint(-5, 50, 5), rng.randint(-5, 50, 5),
         rng.randint(0, 40, 5), rng.randint(0, 40, 5)], -1)]).astype(np.int32)
    ta, tb = _t(a), _t(b)
    for name in ("centers", "areas"):
        assert np.array_equal(getattr(boxes, name)(ta).numpy(),
                              np.asarray(getattr(jax_boxes, name)(a)))
    for name in ("iou_matrix", "contains"):
        got = getattr(boxes, name)(ta, tb).numpy()
        want = np.asarray(jax.jit(getattr(jax_boxes, name))(a, b))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for scale in (0.5, 1.7, 2.5):
        assert np.array_equal(boxes.scale_boxes(ta, scale).numpy(),
                              np.asarray(jax_boxes.scale_boxes(a, scale)))
    for x, y in zip(a, b):
        assert boxes.iou(x, y) == jax_boxes.iou(x, y)
    for cap in (3, 10):
        for g, w in zip(boxes.pad_boxes(a, cap), jax_boxes.pad_boxes(a, cap)):
            assert np.array_equal(g, w)
