"""The PyTorch port's face path against the JAX package on the CPU:
``FaceDetector.process`` must return identical tracked faces (ids and
rects), frame by frame, at 1280x720 and 640x480, with the GOP default and
with ``process_x_every_4_frames=2`` (whose odd sub-batches go through
``bucket_pad``). Also: the port imports no JAX, and a CUDA request on a
host without CUDA raises instead of running on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.face import FaceDetector as JaxFaceDetector
from nubomedia_vca_tpu.models.face import (FaceDetectorConfig as
                                           JaxFaceDetectorConfig)
from nubomedia_vca_tpu_torch.models.base import bucket_pad
from nubomedia_vca_tpu_torch.models.face import (FaceDetector,
                                                 FaceDetectorConfig)
from nubomedia_vca_tpu_torch.utils.synth import face_clip

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as_tuples(faces):
    return [[(f.id, f.rect()) for f in fs] for fs in faces]


@pytest.fixture(scope="module")
def clips():
    return {size: face_clip(6, *size, seed=2)
            for size in ((1280, 720), (640, 480))}


@pytest.mark.parametrize("size", [(1280, 720), (640, 480)])
@pytest.mark.parametrize("x_every_4", [4, 2])
def test_process_matches_jax(clips, size, x_every_4):
    """x=4 processes all 4 frames of each call; x=2 processes frames 1, 3
    and 5 of the first 6 — a batch of 3, which bucket_pad pads to 4 — and
    4 of the next 8, so every call reuses one compiled JAX batch shape."""
    clip = clips[size][:4] if x_every_4 == 4 else clips[size]
    if x_every_4 == 2:
        assert bucket_pad(clip[::2])[0].shape[0] == 4
    jfd = JaxFaceDetector(size, JaxFaceDetectorConfig(
        process_x_every_4_frames=x_every_4))
    pfd = FaceDetector(size, FaceDetectorConfig(
        process_x_every_4_frames=x_every_4))
    want = _as_tuples(jfd.process(clip))
    got = _as_tuples(pfd.process(clip))
    assert got == want
    assert sum(len(f) for f in got) > 0
    # a second call continues the same tracks (ids, GOP counter)
    more = clip[:4] if x_every_4 == 4 else np.concatenate([clip, clip[:2]])
    assert _as_tuples(pfd.process(more)) == _as_tuples(jfd.process(more))


def test_detect_boxes_ungrouped_matches_jax(clips):
    """min_neighbors=0: raw candidates scaled back to frame coordinates."""
    clip = clips[(1280, 720)][:4]
    jfd = JaxFaceDetector((1280, 720), JaxFaceDetectorConfig(min_neighbors=0))
    pfd = FaceDetector((1280, 720), FaceDetectorConfig(min_neighbors=0))
    for g, w in zip(pfd.detect_boxes(clip), jfd.detect_boxes(clip)):
        assert len(w) > 0
        assert np.array_equal(np.sort(g, axis=0), np.sort(w, axis=0))


def test_jax_face_detector_fires_on_synth_frames(clips):
    """The cv2-free synthetic frames (utils/synth.py) that chip_smoke.py
    uses really fire the JAX package's detector: the non-vacuity check of
    the GPU run rests on this."""
    jfd = JaxFaceDetector((1280, 720))
    faces = jfd.process(clips[(1280, 720)][:4])
    assert all(len(f) >= 1 for f in faces)


def test_reconfigure_keeps_tracks_and_swaps_engine(clips):
    clip = clips[(640, 480)][:4]
    fd = FaceDetector((640, 480))
    first = fd.process(clip)
    eng = fd.engine
    fd.reconfigure(FaceDetectorConfig(multi_scale_factor=20))
    assert fd.engine is not eng and fd.engine.scale_factor == 1.2
    assert fd.tracks[0].faces == first[-1]
    assert fd.gop.counter == 4


def test_port_imports_no_jax():
    """Importing the port's face path, its kernel wrapper and chip_smoke.py
    leaves jax and the JAX package out of sys.modules."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import nubomedia_vca_tpu_torch.models.face\n"
        "import nubomedia_vca_tpu_torch.ops.cuda.dense_cuda\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nubomedia_vca_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        FaceDetector((1280, 720), device="cuda")
