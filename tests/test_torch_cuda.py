"""CUDA tests of the PyTorch port: the hand-written pyramid dense kernel
against its plain PyTorch version on the card, and the face path on CUDA
against the port's CPU run.

Every test here is marked ``cuda`` and skips on a host without a GPU. On a
GPU host without JAX, run them with

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine, load_cascade
from nubomedia_vca_tpu_torch.models.face import (DEFAULT_FACE_CASCADE,
                                                 FaceDetector)
from nubomedia_vca_tpu_torch.ops.cuda import dense_cuda
from nubomedia_vca_tpu_torch.utils.synth import face_clip, face_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _levels_equal(got, want):
    for li, ((gi, gv, ga), (wi, wv, wa)) in enumerate(zip(got, want)):
        assert (gi is None) == (wi is None), li
        if gi is not None:
            assert torch.equal(gi, wi), f"level {li} image"
        assert torch.equal(gv, wv), f"level {li} vnf"
        assert torch.equal(ga, wa), f"level {li} alive"


@pytest.mark.parametrize("size,factor", [((160, 90), 1.25),
                                         ((160, 120), 1.25),
                                         ((97, 61), 1.1)])
def test_kernel_equals_plain_version(cuda_device, size, factor):
    """Exact equality (level images, vnf, alive) on faces and on noise, at
    the main path's work sizes and an odd geometry."""
    w, h = size
    eng = CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), size, factor,
                        device=cuda_device)
    frames = np.stack(
        [face_scene(w, h, faces=((w // 2, h // 2, h // 3),), seed=s)
         for s in range(4)]
        + [np.random.RandomState(s).randint(0, 256, (h, w), np.uint8)
           for s in range(4)])
    work = torch.from_numpy(frames).to(cuda_device)
    before = dense_cuda.pyramid_dense_phase.launches
    got = dense_cuda.pyramid_dense_phase(work, eng._plan)
    assert dense_cuda.pyramid_dense_phase.launches == before + 1
    want = dense_cuda.pyramid_dense_phase_reference(work, eng._plan)
    torch.cuda.synchronize()
    _levels_equal(got, want)
    assert sum(int(a.sum()) for _, _, a in got) > 0


def test_kernel_wrapper_checks_inputs(cuda_device):
    eng = CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), (160, 90),
                        device=cuda_device)
    good = torch.zeros((2, 90, 160), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        dense_cuda.pyramid_dense_phase(good.to(torch.int32), eng._plan)
    with pytest.raises(ValueError):
        dense_cuda.pyramid_dense_phase(good[:, :80], eng._plan)
    with pytest.raises(ValueError):
        dense_cuda.pyramid_dense_phase(
            torch.zeros((2, 160, 90), dtype=torch.uint8,
                        device=cuda_device).transpose(1, 2), eng._plan)


def test_large_level_raises_on_cuda(cuda_device):
    """A 320-px work image has levels beyond one block's shared memory: the
    engine refuses them on CUDA instead of running them elsewhere."""
    with pytest.raises(NotImplementedError, match="strip"):
        CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), (320, 180),
                      device=cuda_device)


def test_face_process_cuda_equals_cpu(cuda_device):
    clip = face_clip(8, 1280, 720)
    fd_gpu = FaceDetector((1280, 720), device=cuda_device)
    fd_cpu = FaceDetector((1280, 720), device="cpu")
    got = fd_gpu.process(clip)
    want = fd_cpu.process(clip)
    as_t = lambda faces: [[(f.id, f.rect()) for f in fs] for fs in faces]
    assert as_t(got) == as_t(want)
    assert sum(len(f) for f in got) > 0
