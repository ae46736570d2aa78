"""The port's cascade tooling against the JAX package on the CPU:

* ``cascade/convert.py``: the XML it writes equals the JAX package's byte
  for byte for frontalface_alt, lefteye_2splits (tilted) and smile, new →
  old and old → new; the round trip loads into the port's loader equal to
  the source (as ``tests/test_cascade_loader.py`` holds it), and an engine
  built from the old-format face file detects exactly as one built from
  the original;
* ``cascade/train.py``: ``feature_values`` equals the JAX module's bit for
  bit (the GEMM is exact); the 2^24 guard raises on an oversized window
  before any sample is drawn; a tiny ``train_cascade`` (as in
  ``tests/test_trained_cascades.py``) gives the JAX trainer's stages
  (feature, threshold, leaf values) and XML bytes, and the XML drives the
  port's engine;
* ``utils/offline_images.py``: the same photos as the JAX registry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.cascade import convert as jconvert
from nubomedia_vca_tpu.cascade import train as jtrain
from nubomedia_vca_tpu.models.synth import make_samplers
from nubomedia_vca_tpu.utils.offline_images import (offline_photos as
                                                    jax_photos)
from nubomedia_vca_tpu_torch.cascade import convert, train
from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine
from nubomedia_vca_tpu_torch.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu_torch.utils.offline_images import offline_photos
from nubomedia_vca_tpu_torch.utils.synth import face_clip

from .fixtures import FACE_XML, LEFT_EYE_XML, SMILE_XML

torch.set_num_threads(2)

TINY = dict(window=(12, 12), n_stages=2, n_pos=300, n_neg=600,
            max_features=400, max_weaks_per_stage=10, verbose=False)


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _assert_semantically_equal(g, ref):
    """``tests/test_cascade_loader.py``'s equality: the same arrays, and
    every weak's features the same rects, weights and tilt."""
    assert (g.window_w, g.window_h) == (ref.window_w, ref.window_h)
    for name in ("thr0", "thrL", "thrR", "leavesL", "leavesR",
                 "weak_stage", "stage_thresholds"):
        np.testing.assert_array_equal(getattr(g, name), getattr(ref, name),
                                      err_msg=name)
    for name in ("feat0", "featL", "featR"):
        gi, ri = getattr(g, name), getattr(ref, name)
        np.testing.assert_array_equal(g.rects[gi], ref.rects[ri])
        np.testing.assert_array_equal(g.rect_weights[gi],
                                      ref.rect_weights[ri])
        np.testing.assert_array_equal(g.tilted[gi], ref.tilted[ri])


# ------------------------------------------------------------- convert
@pytest.mark.parametrize("xml", [FACE_XML, LEFT_EYE_XML, SMILE_XML])
def test_convert_bytes_equal_jax_both_ways(xml, tmp_path):
    old, jold = str(tmp_path / "old.xml"), str(tmp_path / "jold.xml")
    assert convert.main([xml, old, "--to-old"]) == 0
    jconvert.new_to_old_xml(xml, jold)
    assert _bytes(old) == _bytes(jold)
    new, jnew = str(tmp_path / "new.xml"), str(tmp_path / "jnew.xml")
    convert.old_to_new_xml(old, new)
    jconvert.old_to_new_xml(old, jnew)
    assert _bytes(new) == _bytes(jnew)
    ref = load_cascade_xml(xml)
    _assert_semantically_equal(load_cascade_xml(old), ref)
    _assert_semantically_equal(load_cascade_xml(new), ref)


def test_old_format_face_file_drives_the_engine(tmp_path):
    old = str(tmp_path / "face_old.xml")
    convert.new_to_old_xml(FACE_XML, old)
    frames = face_clip(2, 160, 120, seed=3)
    got = CascadeEngine(load_cascade_xml(old), (160, 120), 1.25,
                        device="cpu")
    want = CascadeEngine(load_cascade_xml(FACE_XML), (160, 120), 1.25,
                         device="cpu")
    g, w = got.candidates(frames), want.candidates(frames)
    assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert sum(len(c) for c in w) > 0
    for a, b in zip(got.detect(frames), want.detect(frames)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- trainer
def test_feature_values_equal_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    feats = train.feature_pool(20, 20, max_features=500, seed=1)
    assert feats == jtrain.feature_pool(20, 20, max_features=500, seed=1)
    mat = train.corner_matrix(feats, 20, 20)
    np.testing.assert_array_equal(mat, jtrain.corner_matrix(feats, 20, 20))
    # noise, a flat patch (invalid) and saturated windows: the largest
    # patch values the GEMM can see
    samples = rng.randint(0, 256, (300, 20, 20)).astype(np.uint8)
    samples[1] = 128
    samples[2] = 255
    samples[3, ::2] = 255
    samples[3, 1::2] = 0
    got = train.feature_values(samples, mat, chunk=128, device="cpu")
    want = jtrain.feature_values(samples, mat)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    v, ok = train.vnf_and_valid(samples)
    jv, jok = jtrain.vnf_and_valid(samples)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(ok, jok)
    assert not ok[1] and ok[3]


def test_exact_gemm_guard_raises_on_an_oversized_pool():
    """20x20 center-surround features reach 102000·40 < 2^24; at 48x48
    they reach 587520·40 ≥ 2^24, and the trainer refuses before it draws
    a sample."""
    train.check_exact_gemm(train.corner_matrix(
        train.feature_pool(20, 20), 20, 20), 20, 20)
    feats = train.feature_pool(48, 48, pos_step=12, size_step=12)
    with pytest.raises(ValueError, match="2\\^24"):
        train.check_exact_gemm(train.corner_matrix(feats, 48, 48), 48, 48)
    mat = train.corner_matrix(train.feature_pool(12, 12), 12, 12)
    with pytest.raises(ValueError, match="non-integer"):
        train.check_exact_gemm(mat * 0.5, 12, 12)

    def never(n, rng):
        raise AssertionError("sampled before the guard")

    cfg = train.TrainConfig(window=(48, 48), pos_step=12, size_step=12,
                            verbose=False)
    with pytest.raises(ValueError, match="2\\^24"):
        train.train_cascade(never, never, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_cascade(never, never, dataclasses.replace(
            cfg, window=(12, 12)))           # the default device: a card


@pytest.fixture(scope="module")
def tiny_models():
    pos_s, neg_s = make_samplers("nose", window=(12, 12))
    got = train.train_cascade(pos_s, neg_s, train.TrainConfig(**TINY),
                              device="cpu")
    want = jtrain.train_cascade(pos_s, neg_s, jtrain.TrainConfig(**TINY))
    return got, want


def test_tiny_train_cascade_equals_jax(tiny_models, tmp_path):
    got, want = tiny_models
    assert got.stages, "no stage trained"
    assert got.feats == want.feats
    assert len(got.stages) == len(want.stages)
    for gs, ws in zip(got.stages, want.stages):
        assert gs.threshold == ws.threshold
        assert [dataclasses.astuple(w) for w in gs.weaks] == \
            [dataclasses.astuple(w) for w in ws.weaks]
    p, jp = str(tmp_path / "port.xml"), str(tmp_path / "jax.xml")
    train.write_cascade_xml(p, got)
    jtrain.write_cascade_xml(jp, want)
    assert _bytes(p) == _bytes(jp)


def test_trained_xml_drives_the_engine(tiny_models, tmp_path):
    path = str(tmp_path / "tiny.xml")
    train.write_cascade_xml(path, tiny_models[0])
    c = load_cascade_xml(path)
    assert (c.window_w, c.window_h) == (12, 12)
    assert c.n_stages == len(tiny_models[0].stages)
    eng = CascadeEngine(c, (64, 48), 1.1, device="cpu")
    frames = np.random.RandomState(5).randint(0, 256, (2, 48, 64)).astype(
        np.uint8)
    assert len(eng.detect(frames, 3)) == 2
    assert eng.routes == ["pyramid"] * len(eng.levels)


# ------------------------------------------------------- offline photos
def test_offline_photos_equal_jax_registry():
    got, want = offline_photos(), jax_photos()
    assert [(p.name, p.n_faces) for p in got] == \
        [(p.name, p.n_faces) for p in want]
    for g, w in zip(got, want):
        assert g.bgr.dtype == np.uint8 and g.bgr.shape[2] == 3
        np.testing.assert_array_equal(g.bgr, w.bgr)
    for faces in (True, False):
        assert [p.name for p in offline_photos(faces)] == \
            [p.name for p in jax_photos(faces)]
    if any(p.n_faces for p in got):
        assert offline_photos(True)[0].name == "grace_hopper.jpg"


def test_offline_photos_skip_what_cannot_be_read(monkeypatch):
    """Without cv2 the portrait cannot be decoded: it is left out rather
    than raising (the registry's callers skip)."""
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert all(p.name != "grace_hopper.jpg" for p in offline_photos())
