"""The PyTorch port's nose and mouth detectors against the JAX package's on
the CPU: 640x480 frames at ``width_to_process=160`` (a 160x120 part image;
the face pass at 160 too), two frames of the synthetic face clip, two
``process`` calls of one stream so the temporal merges run.

Per-frame outputs must be equal, and so must the device pass's raw
results slot for slot: the grouped faces and the compacted raw part
candidates with their overflow flags (the mouth's cascade overflows a
level's capacity on these frames). Every level of the mouth, its 160x120
first level included, takes the tilted kernels' plain version; the nose
is a no-block cascade.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.mouth import MouthDetector as JaxMouth
from nubomedia_vca_tpu.models.mouth import (MouthDetectorConfig as
                                            JaxMouthConfig)
from nubomedia_vca_tpu.models.nose import NoseDetector as JaxNose
from nubomedia_vca_tpu.models.nose import NoseDetectorConfig as JaxNoseConfig
from nubomedia_vca_tpu_torch.models import (MouthDetector,
                                            MouthDetectorConfig, NoseDetector,
                                            NoseDetectorConfig)
from nubomedia_vca_tpu_torch.utils.synth import face_clip

torch.set_num_threads(2)

FRAME = (640, 480)


@pytest.fixture(scope="module")
def clip():
    return face_clip(2, *FRAME, seed=11)


def _raw_equal(got, want):
    face, parts = got
    w_face, w_parts = want
    for g, w in zip(face, w_face):
        assert np.array_equal(g, np.asarray(w))
    assert parts.keys() == w_parts.keys()
    for name in parts:
        for g, w in zip(parts[name], w_parts[name]):
            assert np.array_equal(g, np.asarray(w)), name


CASES = {
    "nose": (NoseDetector, NoseDetectorConfig, JaxNose, JaxNoseConfig),
    "mouth": (MouthDetector, MouthDetectorConfig, JaxMouth, JaxMouthConfig),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def detectors(request):
    port, port_cfg, jax_det, jax_cfg = CASES[request.param]
    return (request.param,
            port(FRAME, port_cfg(width_to_process=160), device="cpu"),
            jax_det(FRAME, jax_cfg(width_to_process=160)))


def test_process_matches_jax(detectors, clip):
    name, pdet, jdet = detectors
    for _ in range(2):
        got, want = pdet.process(clip), jdet.process(clip)
        assert got == want
    if name == "nose":
        assert all(len(r["nose"]) == 1 for r in got)


def test_device_pass_matches_jax(detectors, clip):
    """Grouped faces and compacted raw part candidates, slot for slot, with
    the overflow flags."""
    name, pdet, jdet = detectors
    got = pdet._device_pass(clip)
    _raw_equal(got, jdet._device_pass(clip))
    face_valid = got[0][1]
    assert face_valid.sum(1).tolist() == [1, 1]
    boxes, valid, overflow = got[1][name]
    assert valid.sum() > 0
    if name == "mouth":
        assert overflow.all()     # a level's survivors exceed its capacity


def test_part_engine_routes(detectors):
    name, pdet, _ = detectors
    eng = pdet.part_engines[name]
    assert (eng.image_w, eng.image_h) == (160, 120)
    if name == "mouth":
        assert eng.routes == ["tilted"] * len(eng.levels)
    else:
        assert eng.routes == ["pyramid"] * len(eng.levels)
        assert not eng._blocks
