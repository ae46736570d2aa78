"""The PyTorch port's eye detector against the JAX package's on the CPU:
640x480 frames at ``width_to_process=160``, two frames of the synthetic
face clip, through the face pass and through the detect-event path, where
upstream face boxes are fed in.

The 2splits eye cascades find no eye on the cartoon faces, so the
comparison is made non-vacuous below the final boxes: the dense phase of
both eye engines keeps windows alive on these frames, and the raw outputs
(boxes, valid slots, overflow) of the port and the JAX engines agree slot
for slot. ``tests/test_torch_engine.py`` holds a truncated eye cascade
whose candidates do survive against the JAX engine.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.eye import EyeDetector as JaxEye
from nubomedia_vca_tpu.models.eye import EyeDetectorConfig as JaxEyeConfig
from nubomedia_vca_tpu_torch.models import EyeDetector, EyeDetectorConfig
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact
from nubomedia_vca_tpu_torch.utils.synth import face_clip

torch.set_num_threads(2)

FRAME = (640, 480)


@pytest.fixture(scope="module")
def clip():
    return face_clip(2, *FRAME, seed=11)


@pytest.fixture(scope="module")
def detectors():
    return (EyeDetector(FRAME, EyeDetectorConfig(width_to_process=160),
                        device="cpu"),
            JaxEye(FRAME, JaxEyeConfig(width_to_process=160)))


def test_eye_process_matches_jax(detectors, clip):
    pdet, jdet = detectors
    for _ in range(2):
        assert pdet.process(clip) == jdet.process(clip)


def test_eye_device_pass_matches_jax(detectors, clip):
    pdet, jdet = detectors
    (face, parts), (w_face, w_parts) = (pdet._device_pass(clip),
                                        jdet._device_pass(clip))
    for g, w in zip(face, w_face):
        assert np.array_equal(g, np.asarray(w))
    assert face[1].sum(1).tolist() == [1, 1]
    for name in ("right", "left"):
        for g, w in zip(parts[name], w_parts[name]):
            assert np.array_equal(g, np.asarray(w)), name


@pytest.mark.parametrize("side", ["right", "left"])
def test_eye_engine_dense_phase_is_not_vacuous(detectors, clip, side):
    """Every level of the eye engine, the 160x120 first one included, goes
    through the tilted kernels' plain version, and the dense phase keeps
    windows alive on the face frames; the engine's raw output equals the
    JAX engine's slot for slot."""
    pdet, jdet = detectors
    eng = pdet.part_engines[side]
    assert eng.routes == ["tilted"] * len(eng.levels)
    work = equalize_hist(resize_linear_exact(
        torch.from_numpy(clip), (eng.image_w, eng.image_h)))
    alive = sum(int(eng._dense_level(work, li)[2].sum())
                for li in range(len(eng.levels)))
    assert alive > 0
    got = eng.detect_raw(work)
    want = jdet.part_engines[side].detect_raw(jnp.asarray(work.numpy()))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_eye_event_fed_faces_match_jax(detectors, clip):
    """detect-event path: face boxes supplied by an upstream detector
    replace the face pass's; the gate's budget and the pending boxes
    persist across calls."""
    face = np.array([[160, 80, 304, 304]])   # original coordinates
    out = []
    for det, cfg in ((EyeDetector, EyeDetectorConfig),
                     (JaxEye, JaxEyeConfig)):
        kw = {"device": "cpu"} if det is EyeDetector else {}
        d = det(FRAME, cfg(detect_event=1, width_to_process=160), **kw)
        d.gate.feed_event()
        res = d.process(clip, face_boxes=[face, None])
        res += d.process(clip, face_boxes=[None, None])
        out.append((res, d.gate.budget))
    assert out[0] == out[1]
    assert all(set(r) == {"eye_right", "eye_left"} for r in out[0][0])
