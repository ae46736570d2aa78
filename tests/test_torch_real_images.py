"""The port's part chain on a real photograph against the JAX package on
the CPU: ``NoseDetector`` and ``MouthDetector`` at the default part width
320 on the Grace Hopper portrait (``utils/offline_images``), the chain
``tests/test_real_images.py::test_part_chain_real_photo`` runs in the JAX
package, and (``full`` tier) ``EyeDetector`` at part width 480, as
``test_part_chain_real_photo_eye_480`` runs it. ``process()`` must return
equal results, and so must the device pass's grouped faces and compacted
raw part candidates, slot for slot. Skipped where no face-bearing
photograph is installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.eye import EyeDetector as JaxEye
from nubomedia_vca_tpu.models.eye import EyeDetectorConfig as JaxEyeConfig
from nubomedia_vca_tpu.models.mouth import MouthDetector as JaxMouth
from nubomedia_vca_tpu.models.nose import NoseDetector as JaxNose
from nubomedia_vca_tpu_torch.models import (EyeDetector, MouthDetector,
                                            NoseDetector)
from nubomedia_vca_tpu_torch.models.eye import EyeDetectorConfig
from nubomedia_vca_tpu_torch.utils.offline_images import offline_photos

torch.set_num_threads(2)

CASES = {"nose": (NoseDetector, JaxNose), "mouth": (MouthDetector, JaxMouth)}


@pytest.fixture(scope="module")
def gray():
    photos = offline_photos(faces=True)
    if not photos:
        pytest.skip("no face-bearing offline photograph installed")
    import cv2

    return cv2.cvtColor(photos[0].bgr, cv2.COLOR_BGR2GRAY)[None]


@pytest.fixture(scope="module", params=sorted(CASES))
def results(request, gray):
    """(name, port detector, port process(), JAX process(), JAX device
    pass) for one detector at the default config."""
    port_cls, jax_cls = CASES[request.param]
    size = (gray.shape[2], gray.shape[1])
    pdet, jdet = port_cls(size, device="cpu"), jax_cls(size)
    return (request.param, pdet, pdet.process(gray), jdet.process(gray),
            jdet._device_pass(gray))


def test_process_matches_jax(results):
    name, pdet, got, want, _ = results
    assert pdet.part_w == 320
    assert got == want
    assert len(got[0][name]) >= 1, "the part fires on the portrait"


def test_device_pass_matches_jax(results, gray):
    name, pdet, _, _, want = results
    face, parts = pdet._device_pass(gray)
    for g, w in zip(face, want[0]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert face[1].sum() >= 1, "the face pass finds the portrait's face"
    for g, w in zip(parts[name], want[1][name]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.full
def test_eye_480_matches_jax(gray):
    """The eye at part width 480 (both 2splits cascades, tilted): process()
    and the device pass's grouped faces and compacted raw candidates of
    each eye equal the JAX package's, and the left eye fires."""
    size = (gray.shape[2], gray.shape[1])
    pdet = EyeDetector(size, EyeDetectorConfig(width_to_process=480),
                       device="cpu")
    jdet = JaxEye(size, JaxEyeConfig(width_to_process=480))
    assert pdet.part_w == 480
    got, want = pdet.process(gray), jdet.process(gray)
    assert got == want
    assert len(got[0]["eye_left"]) >= 1, "the left eye fires at 480"
    face, parts = pdet._device_pass(gray)
    jface, jparts = jdet._device_pass(gray)
    for g, w in zip(face, jface):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert sorted(parts) == sorted(jparts) == ["left", "right"]
    for name in parts:
        for g, w in zip(parts[name], jparts[name]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
