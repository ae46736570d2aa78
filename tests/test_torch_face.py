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
from nubomedia_vca_tpu_torch.api.render import render_detections
from nubomedia_vca_tpu_torch.models import (CnnFaceDetector, EarDetector,
                                           EyeDetector, FaceDetector,
                                           FaceDetectorConfig, MouthDetector,
                                           NoseDetector,
                                           QuantizedCnnFaceDetector, Tracker)
from nubomedia_vca_tpu_torch.models.tracker import TrackerState, init_state
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
        process_x_every_4_frames=x_every_4), device="cpu")
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
    pfd = FaceDetector((1280, 720), FaceDetectorConfig(min_neighbors=0),
                       device="cpu")
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
    fd = FaceDetector((640, 480), device="cpu")
    first = fd.process(clip)
    eng = fd.engine
    fd.reconfigure(FaceDetectorConfig(multi_scale_factor=20))
    assert fd.engine is not eng and fd.engine.scale_factor == 1.2
    assert fd.tracks[0].faces == first[-1]
    assert fd.gop.counter == 4


def test_port_imports_no_jax():
    """Importing every module of the port (found by pkgutil.walk_packages,
    so a new module is covered without listing it), chip_smoke.py,
    bench_torch.py and every ``tools/torch_*.py`` and
    ``examples/torch_*.py`` leaves jax and the JAX package out of
    sys.modules."""
    code = (
        "import glob, importlib, importlib.util, pkgutil, sys\n"
        "import chip_smoke\n"
        "import bench_torch\n"
        "scripts = sorted(glob.glob('tools/torch_*.py') + "
        "glob.glob('examples/torch_*.py'))\n"
        "for i, path in enumerate(scripts):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', "
        "path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert len(scripts) == 9, scripts\n"
        "import nubomedia_vca_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'nubomedia_vca_tpu_torch.models.quant' in names, names\n"
        "assert 'nubomedia_vca_tpu_torch.ops.cuda.quant_cuda' in names\n"
        "for mod in ('models.ear', 'models.tracker', 'api.render', "
        "'api.rpc', 'api.media_loop', 'api.objects', 'api.idl', "
        "'cpp.ingest_binding', 'cli', 'models.cnn_parts', "
        "'pipeline.scheduler', 'utils.tracing', 'models.distill', "
        "'models.synth', 'models.textures', 'utils.checkpoint', "
        "'utils.offline_images', 'cascade.convert', 'cascade.train', "
        "'parallel.mesh', 'parallel.sharded', 'parallel.dryrun', "
        "'entry'):\n"
        "    assert 'nubomedia_vca_tpu_torch.' + mod in names, mod\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nubomedia_vca_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split()[0] == "ok"


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        FaceDetector((1280, 720), device="cuda")


@pytest.mark.parametrize("make", [
    lambda: EarDetector((1280, 720), device="cuda"),
    lambda: Tracker((1280, 720), device="cuda"),
    lambda: init_state(720, 1280, device="cuda"),
    lambda: render_detections(np.zeros((1, 4, 4), np.uint8), [[]],
                              device="cuda"),
], ids=["ear", "tracker", "init_state", "render"])
def test_cuda_request_raises_without_cuda_for_slice_entry_points(make):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        make()


@pytest.mark.parametrize("make", [
    lambda: init_state(720, 1280),
    lambda: TrackerState.from_numpy(np.zeros((2, 2), np.uint8),
                                    np.zeros((2, 2), np.float32), True),
    lambda: render_detections(np.zeros((1, 4, 4), np.uint8), [[]]),
], ids=["init_state", "from_numpy", "render"])
def test_tracker_state_and_render_default_to_cuda(make):
    """Without a device argument the tracker's state and rendering of
    numpy frames go to the card: on a host without CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        make()


@pytest.mark.parametrize("detector", [FaceDetector, NoseDetector,
                                      MouthDetector, EyeDetector,
                                      CnnFaceDetector,
                                      QuantizedCnnFaceDetector, EarDetector,
                                      Tracker])
def test_entry_points_default_to_cuda(detector):
    """Without a device argument every detector runs on the card: on a host
    without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        detector((1280, 720))
