"""The port's checkpoints (``nubomedia_vca_tpu_torch/utils/checkpoint.py``)
on the CPU: the training state round trip is exact (parameters, AdamW's
moments and count, the schedule's position, and the next step), and the
runtime snapshots cross between the packages: a snapshot the JAX package
wrote resumes the port's ``FaceDetector`` and ``Tracker`` exactly as the
JAX detectors resume, and the reverse."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.face import FaceDetector as JaxFaceDetector
from nubomedia_vca_tpu.models.tracker import Tracker as JaxTracker
from nubomedia_vca_tpu.utils import checkpoint as jckpt
from nubomedia_vca_tpu_torch.models import FaceDetector, NoseDetector, Tracker
from nubomedia_vca_tpu_torch.models import cnn
from nubomedia_vca_tpu_torch.utils import checkpoint as ckpt

from .fixtures import face_clip, moving_blob_clip

torch.set_num_threads(2)

SMALL = {"channels": (8, 8, 8, 8), "head_dim": 16}


def _trainer(seed):
    model = cnn.CnnNet(cnn.init_params(torch.Generator().manual_seed(seed),
                                       ctx=True, **SMALL))
    opt, sched = cnn.make_optimizer(model.parameters(), 3e-4, steps=20)
    return model, opt, sched


def _batches(n):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        gray = torch.from_numpy(rs.randint(0, 256, (2, 64, 64), np.uint8))
        boxes = torch.from_numpy(
            rs.randint(8, 40, (2, 3, 4)).astype(np.float32))
        valid = torch.from_numpy(rs.rand(2, 3) < 0.7)
        out.append((gray, *cnn.boxes_to_targets(boxes, valid, 64, 64)))
    return out


def test_train_state_round_trip(tmp_path):
    batches = _batches(4)
    model, opt, sched = _trainer(0)
    for b in batches[:3]:
        cnn.train_step(model, opt, sched, *b)
    ckpt.save_train_state(str(tmp_path), model, opt, sched, step=3)
    assert os.path.exists(tmp_path / "step_3" / "state.pt")
    model2, opt2, sched2 = _trainer(1)       # other weights, fresh state
    assert ckpt.load_train_state(str(tmp_path), model2, opt2, sched2) == 3
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(a, b), k
    for p, p2 in zip(model.parameters(), model2.parameters()):
        s, s2 = opt.state[p], opt2.state[p2]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[key], s2[key]), key
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"] > 0
    assert sched2.last_epoch == sched.last_epoch == 3
    want, _ = cnn.train_step(model, opt, sched, *batches[3])
    got, _ = cnn.train_step(model2, opt2, sched2, *batches[3])
    assert torch.equal(got, want)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def clips():
    return face_clip(4), moving_blob_clip(6)


def _run(fd, tr, faces, blobs):
    res = fd.process(faces)
    return ([[(f.id, f.rect()) for f in fr] for fr in res],
            tr.process(blobs))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_runtime_snapshot_crosses_packages(tmp_path, clips, writer):
    """One package processes the first frames and writes the snapshot; the
    other package's fresh detectors load it and process the rest exactly
    as the writer's own detectors continue."""
    faces, blobs = clips
    if writer == "jax":
        fd, tr = JaxFaceDetector((640, 480)), JaxTracker((320, 240))
        fd2 = FaceDetector((640, 480), device="cpu")
        tr2 = Tracker((320, 240), device="cpu")
        save, load = jckpt.save_runtime, ckpt.load_runtime
    else:
        fd = FaceDetector((640, 480), device="cpu")
        tr = Tracker((320, 240), device="cpu")
        fd2, tr2 = JaxFaceDetector((640, 480)), JaxTracker((320, 240))
        save, load = ckpt.save_runtime, jckpt.load_runtime
    first = _run(fd, tr, faces[:2], blobs[:3])
    assert any(first[0])                     # a face is tracked
    path = str(tmp_path / "runtime.pkl")
    save(path, {"face": fd, "tracker": tr})
    load(path, {"face": fd2, "tracker": tr2})
    assert tr2.frame_idx == tr.frame_idx == 3
    t, t2 = fd.tracks[0], fd2.tracks[0]
    assert t2.next_id == t.next_id == 1
    assert [f.rect() for f in t2.faces] == [f.rect() for f in t.faces]
    assert np.array_equal(np.asarray(tr2.state.mhi), np.asarray(
        tr.state.mhi if writer == "jax" else tr.state.mhi.numpy()))
    want = _run(fd, tr, faces[2:], blobs[3:])
    got = _run(fd2, tr2, faces[2:], blobs[3:])
    assert got == want
    assert any(got[0])          # tracked again, under id 1, not a fresh 0


def test_part_detector_snapshot_round_trip(tmp_path):
    """Per-stream part state and the old single-stream form."""
    det = NoseDetector((320, 240), device="cpu")
    st = det._stream_state(1)
    st.prev = {"nose0": [(1, 2, 3, 4)]}
    st.empty_count = {"nose0": 2}
    st.gop.counter = 5
    det._stream_state(0).gate.budget = 3
    path = str(tmp_path / "parts.pkl")
    ckpt.save_runtime(path, {"nose": det})
    det2 = NoseDetector((320, 240), device="cpu")
    ckpt.load_runtime(path, {"nose": det2})
    assert ckpt.snapshot_detector(det2) == ckpt.snapshot_detector(det)
    old = {"prev": {"nose0": [[5, 6, 7, 8]]}, "gop_counter": 2,
           "gate_budget": 1}
    det3 = NoseDetector((320, 240), device="cpu")
    ckpt.restore_detector(det3, old)
    assert det3._prev == {"nose0": [(5, 6, 7, 8)]}
    assert (det3.gop.counter, det3.gate.budget) == (2, 1)
