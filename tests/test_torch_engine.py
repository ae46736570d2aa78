"""The PyTorch port's CascadeEngine against the JAX package's on the CPU,
at the main path's 160x90 work size (1280x720 at the 160-px working width).

The cascade crosses over as numpy fields (``cascade_from_numpy``); the host
tables must be identical, and ``candidates()``, ``detect()`` and
``detect_grouped()`` must agree exactly on the same uint8 work images.
"""

from __future__ import annotations

import dataclasses
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.cascade.engine import CascadeEngine as JaxEngine
from nubomedia_vca_tpu.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu.ops.histogram import equalize_hist as j_equalize
from nubomedia_vca_tpu.ops.resize import resize_linear_exact as j_resize
from nubomedia_vca_tpu_torch.cascade import engine as port_engine
from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine
from nubomedia_vca_tpu_torch.cascade.xml_loader import (cascade_from_numpy,
                                                        load_cascade_xml as
                                                        port_load)
from nubomedia_vca_tpu_torch.models.face import DEFAULT_FACE_CASCADE
from nubomedia_vca_tpu_torch.utils.synth import face_clip, face_scene

torch.set_num_threads(2)

FACE_XML = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt.xml"
EYE_2SPLITS_XML = ("/usr/share/opencv4/haarcascades/"
                   "haarcascade_lefteye_2splits.xml")
WORK = (160, 90)


@pytest.fixture(scope="module")
def engines():
    casc = load_cascade_xml(FACE_XML)
    jeng = JaxEngine(casc, WORK, 1.25)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)), WORK,
                         1.25)
    return jeng, peng


@pytest.fixture(scope="module")
def work():
    """[4, 90, 160] uint8 work images: three equalized 720p face frames (as
    the face path makes them, here with the JAX ops) and one two-face scene
    drawn at work size."""
    frames = face_clip(3, 1280, 720)
    faces = np.asarray(j_equalize(j_resize(jnp.asarray(frames), WORK)))
    two = face_scene(160, 90, faces=((45, 45, 26), (118, 40, 18)), seed=4)
    return np.concatenate([faces, two[None]])


def test_bundled_cascade_is_opencv_copy():
    assert filecmp.cmp(DEFAULT_FACE_CASCADE, FACE_XML, shallow=False)
    a, b = port_load(DEFAULT_FACE_CASCADE), load_cascade_xml(FACE_XML)
    for f in dataclasses.fields(a):
        if f.name != "name":
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name))


def test_host_tables_equal(engines):
    jeng, peng = engines
    assert ([dataclasses.astuple(l) for l in peng.levels]
            == [dataclasses.astuple(l) for l in jeng.levels])
    assert peng.n_dense_stages == jeng.n_dense_stages == 3
    assert len(peng._dense["feat0"]) == 40
    assert peng._dense.keys() == jeng._dense.keys()
    for k in jeng._dense:
        assert np.array_equal(peng._dense[k], jeng._dense[k]), k
    assert peng._feat_rects == jeng._feat_rects
    assert len(peng._blocks) == len(jeng._blocks) > 0
    for pb, jb in zip(peng._blocks, jeng._blocks):
        for f in dataclasses.fields(jb):
            if f.name == "w_tilt":    # the port refuses tilted cascades
                assert jb.w_tilt is None and not hasattr(pb, "w_tilt")
                continue
            pv, jv = getattr(pb, f.name), getattr(jb, f.name)
            if isinstance(jv, np.ndarray):
                assert pv.dtype == jv.dtype and np.array_equal(pv, jv), f.name
            else:
                assert pv == jv, f.name
    assert peng._level_caps == jeng._level_caps
    assert peng.total_capacity == jeng.total_capacity
    for (px, py), (jx, jy) in zip(peng._maps, jeng._maps):
        assert np.array_equal(px, jx) and np.array_equal(py, jy)


def _sorted(a):
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def test_candidates_match_jax(engines, work):
    jeng, peng = engines
    got, want = peng.candidates(work), jeng.candidates(jnp.asarray(work))
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(_sorted(g), _sorted(w))


@pytest.mark.parametrize("min_neighbors", [3, 1])
def test_detect_matches_jax(engines, work, min_neighbors):
    jeng, peng = engines
    got = peng.detect(work, min_neighbors)
    want = jeng.detect(jnp.asarray(work), min_neighbors)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(_sorted(g), _sorted(w))


def test_detect_grouped_matches_jax_in_valid_slots(engines, work):
    jeng, peng = engines
    got = peng.detect_grouped(work, 3)
    want = jeng.detect_grouped(jnp.asarray(work), 3)
    boxes, valid, weights, overflow = (t.numpy() for t in got)
    w_boxes, w_valid, w_weights, w_overflow = (np.asarray(t) for t in want)
    assert boxes.shape == w_boxes.shape and valid.any()
    assert np.array_equal(valid, w_valid)
    assert np.array_equal(boxes[valid], w_boxes[w_valid])
    assert np.array_equal(weights[valid], w_weights[w_valid])
    assert np.array_equal(overflow, w_overflow)


def test_engine_refuses_tilted_cascade():
    casc = port_load(EYE_2SPLITS_XML)
    assert casc.has_tilted
    with pytest.raises(NotImplementedError, match="build_dense_phase"):
        CascadeEngine(casc, (64, 48), 1.1)


@pytest.mark.parametrize("setting", ["allow_tf32", "precision"])
def test_engine_requires_true_f32_matmul(engines, setting):
    """The engine never flips global matmul switches; it refuses to run
    when TF32 would round its float32 matmuls."""
    _, peng = engines
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32|highest"):
            CascadeEngine(peng.cascade, WORK, 1.25)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_engine_rejects_frames_of_other_size_or_device(engines):
    _, peng = engines
    with pytest.raises(ValueError, match="engine size"):
        peng.detect_raw(np.zeros((1, 120, 160), np.uint8))
    with pytest.raises(ValueError, match="frames on"):
        peng.detect_raw(torch.zeros((1, 90, 160), dtype=torch.uint8,
                                    device="meta"))


def test_get_engine_caches_per_configuration():
    a = port_engine.get_engine(DEFAULT_FACE_CASCADE, WORK, 1.25)
    b = port_engine.get_engine(DEFAULT_FACE_CASCADE, WORK, 1.25, device="cpu")
    c = port_engine.get_engine(DEFAULT_FACE_CASCADE, WORK, 1.2)
    assert a is b and a is not c
    assert a.device == torch.device("cpu")
