"""The PyTorch port's CascadeEngine against the JAX package's on the CPU:
the face cascade at the main path's 160x90 work size (1280x720 at the
160-px working width), a tilted cascade (the eyes' 2splits), and the nose
cascade, whose stages all fall in the dense block, at the part chain's
320x180.

The cascade crosses over as numpy fields (``cascade_from_numpy``); the host
tables must be identical, and ``candidates()``, ``detect()``,
``detect_grouped()`` and ``detect_raw()`` must agree exactly on the same
uint8 work images.
"""

from __future__ import annotations

import dataclasses
import filecmp
import os

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
from nubomedia_vca_tpu_torch.cascade.paths import PKG_ASSETS_DIR
from nubomedia_vca_tpu_torch.cascade.xml_loader import (cascade_from_numpy,
                                                        load_cascade_xml as
                                                        port_load)
from nubomedia_vca_tpu_torch.models.face import DEFAULT_FACE_CASCADE
from nubomedia_vca_tpu_torch.utils.synth import face_clip, face_scene

torch.set_num_threads(2)

FACE_XML = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt.xml"
OPENCV_DIR = "/usr/share/opencv4/haarcascades"
NOSE_XML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))),
    "nubomedia_vca_tpu", "assets", "haarcascades", "vca_nose_synthetic.xml")
WORK = (160, 90)


@pytest.fixture(scope="module")
def engines():
    casc = load_cascade_xml(FACE_XML)
    jeng = JaxEngine(casc, WORK, 1.25)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)), WORK,
                         1.25, device="cpu")
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


@pytest.mark.parametrize("name", [
    "haarcascade_frontalface_alt.xml", "haarcascade_righteye_2splits.xml",
    "haarcascade_lefteye_2splits.xml", "haarcascade_smile.xml",
    "vca_nose_synthetic.xml"])
def test_bundled_cascade_is_opencv_copy(name):
    """The port's cascades are byte-identical copies of OpenCV's (license
    headers included) and of the JAX package's trained nose cascade."""
    source = (NOSE_XML if name.startswith("vca_")
              else os.path.join(OPENCV_DIR, name))
    bundled = os.path.join(PKG_ASSETS_DIR, name)
    assert filecmp.cmp(bundled, source, shallow=False)
    a, b = port_load(bundled), load_cascade_xml(source)
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
        assert jb.w_tilt is None      # the face cascade has no tilted feature
        # the port's matmul block: the JAX block's fields less w_tilt, and
        # the plan's features and tree stages (the JAX block has no such)
        names = {f.name for f in dataclasses.fields(pb)}
        assert names == ({f.name for f in dataclasses.fields(jb)}
                         - {"w_tilt"}) | {"feats", "tree_stage"}
        for name in names - {"feats", "tree_stage"}:
            pv, jv = getattr(pb, name), getattr(jb, name)
            if isinstance(jv, np.ndarray):
                assert pv.dtype == jv.dtype and np.array_equal(pv, jv), name
            else:
                assert pv == jv, name
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


def _truncated(casc, n_stages):
    """The cascade's first n_stages stages (weak trees and thresholds)."""
    keep = casc.weak_stage < n_stages
    return dataclasses.replace(
        casc, feat0=casc.feat0[keep], thr0=casc.thr0[keep],
        featL=casc.featL[keep], thrL=casc.thrL[keep],
        leavesL=casc.leavesL[keep], featR=casc.featR[keep],
        thrR=casc.thrR[keep], leavesR=casc.leavesR[keep],
        weak_stage=casc.weak_stage[keep],
        stage_thresholds=casc.stage_thresholds[:n_stages])


def _raw_equal(got, want):
    """detect_raw outputs equal slot for slot: boxes, valid, overflow."""
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("side,n_stages,n_blocks", [("left", 11, 2),
                                                    ("right", 7, 1)])
def test_tilted_engine_matches_jax(side, n_stages, n_blocks):
    """A tilted cascade (the eyes' 2splits, cut to a few stages so that
    synthetic faces pass them) at 96x72: every level takes the tilted
    dense kernel's plain version, and each block is one evaluation of the
    survivor kernel's plain version on the sum and tilted tables, the
    engine building no matmul form. The raw output equals the JAX
    engine's slot for slot."""
    casc = _truncated(load_cascade_xml(
        f"/usr/share/opencv4/haarcascades/haarcascade_{side}eye_2splits.xml"),
        n_stages)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)),
                         (96, 72), 1.25, device="cpu")
    assert peng.routes == ["tilted"] * len(peng.levels)
    assert len(peng._blocks) == n_blocks
    assert not any(hasattr(b, "w_sum") or hasattr(b, "stage_onehot")
                   for b in peng._blocks)
    assert not hasattr(peng, "_patch_dtype")
    assert not hasattr(peng, "_blocks_dev")
    assert [len(peng._survivor_plans[li]) for li in range(
        len(peng.levels))] == [n_blocks] * len(peng.levels)
    jeng = JaxEngine(casc, (96, 72), 1.25)
    faces = np.stack([face_scene(96, 72, faces=((48, 36, s),), seed=s)
                      for s in (14, 18, 22, 26, 30)])
    noise = np.random.RandomState(1).randint(0, 256, (2, 72, 96), np.uint8)
    work = np.concatenate([np.asarray(j_equalize(jnp.asarray(faces))), noise])
    got, want = peng.detect_raw(work), jeng.detect_raw(jnp.asarray(work))
    _raw_equal(got, want)
    assert got[1].any()


def test_no_block_engine_matches_jax():
    """The nose cascade (3 stages, 6 weak trees: all in the dense block,
    no matmul block) at the part chain's 320x180: every level takes the
    pyramid kernel's route, the four largest (which the JAX engine runs in
    row strips) in bands of 4-10 grid rows; the dense survivors are
    emitted as they are. Raw output equal to the JAX engine's slot for
    slot."""
    casc = load_cascade_xml(NOSE_XML)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)),
                         (320, 180), 1.1, min_size=(1, 1), device="cpu")
    assert not peng._blocks and peng.n_dense_stages == casc.n_stages == 3
    assert peng.routes == ["pyramid"] * 24 and peng._plan.n_wide == 4
    assert [int((peng._plan.items[:, 0] == li).sum()) for li in range(4)] \
        == [17, 13, 9, 6]
    jeng = JaxEngine(casc, (320, 180), 1.1, min_size=(1, 1))
    frames = face_clip(2, 1280, 720, seed=11)
    work = np.asarray(j_equalize(j_resize(jnp.asarray(frames), (320, 180))))
    got, want = peng.detect_raw(work), jeng.detect_raw(jnp.asarray(work))
    _raw_equal(got, want)
    assert got[1].sum() > 0


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
            CascadeEngine(peng.cascade, WORK, 1.25, device="cpu")
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
    a = port_engine.get_engine(DEFAULT_FACE_CASCADE, WORK, 1.25,
                               device="cpu")
    b = port_engine.get_engine(DEFAULT_FACE_CASCADE, WORK, 1.25,
                               device=torch.device("cpu"))
    c = port_engine.get_engine(DEFAULT_FACE_CASCADE, WORK, 1.2, device="cpu")
    assert a is b and a is not c
    assert a.device == torch.device("cpu")


def test_engine_defaults_to_cuda(engines):
    """Without a device argument the engine runs on the card: on a host
    without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, peng = engines
    with pytest.raises(RuntimeError, match="cuda"):
        CascadeEngine(peng.cascade, WORK, 1.25)
    with pytest.raises(RuntimeError, match="cuda"):
        port_engine.get_engine(DEFAULT_FACE_CASCADE, WORK, 1.25)
