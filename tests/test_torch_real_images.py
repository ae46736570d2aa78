"""The port's part chain on a real photograph against the JAX package on
the CPU: ``NoseDetector`` and ``MouthDetector`` at the default part width
320 on the Grace Hopper portrait (``utils/offline_images``), the chain
``tests/test_real_images.py::test_part_chain_real_photo`` runs in the JAX
package. ``process()`` must return equal results, and so must the device
pass's grouped faces and compacted raw part candidates, slot for slot.
Skipped where no face-bearing photograph is installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.mouth import MouthDetector as JaxMouth
from nubomedia_vca_tpu.models.nose import NoseDetector as JaxNose
from nubomedia_vca_tpu_torch.models import MouthDetector, NoseDetector
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
