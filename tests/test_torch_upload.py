"""The face and part detectors' upload through the staging ring
(``models/base.StagingRing``) on the CPU, against the upload it replaced:
the selected frames gathered into a new array, bucket-padded on the host,
copied to the device whole, then resized and equalized. The work batches
must be equal bit for bit, and so must ``FaceDetector.process`` and
``EyeDetector.process``. The ring's counters count only while tracing.
The card's own run (pinned slots, asynchronous copies) is in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine
from nubomedia_vca_tpu_torch.models import base
from nubomedia_vca_tpu_torch.models.base import (StagingRing, bucket_pad,
                                                 select_frames)
from nubomedia_vca_tpu_torch.models.eye import EyeDetector, EyeDetectorConfig
from nubomedia_vca_tpu_torch.models.face import (FaceDetector,
                                                 FaceDetectorConfig)
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact
from nubomedia_vca_tpu_torch.utils import tracing
from nubomedia_vca_tpu_torch.utils.synth import face_clip
from vcabench.frozen.scenes import draw_clip

torch.set_num_threads(2)

W, H = 64, 36                   # the ring's cases
SIZES = [(32, 18), (16, 9)]
SLOT_FRAMES = 4


class PageableUpload:
    """The upload the ring replaced, as a drop-in for a detector's ring."""

    def __init__(self, device):
        self.device = device

    def stage(self, sel, sizes):
        frames, index = sel
        padded, n_real = bucket_pad(frames[index])
        gray = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        return [equalize_hist(resize_linear_exact(gray, s))
                for s in sizes], n_real


def _old_works(gray, mask, sizes):
    gray = np.asarray(gray)
    gray = gray[None] if gray.ndim == 2 else gray
    if mask is None:
        mask = np.ones(len(gray), bool)
    return PageableUpload("cpu").stage((gray, np.flatnonzero(mask)), sizes)


@pytest.fixture
def small_slots(monkeypatch):
    """Slots of SLOT_FRAMES frames of the cases' size."""
    monkeypatch.setattr(base, "STAGE_SLOT_BYTES", SLOT_FRAMES * W * H)


def _clip(n, seed, w=W, h=H):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), np.uint8)


# case → [(frames, mask, sizes)], one call each, in turn on one ring
CASES = {
    "forward": [(_clip(8, 0), None, SIZES)],
    "reversed": [(_clip(8, 1)[::-1], None, SIZES)],
    "rows_reversed": [(_clip(5, 12)[:, ::-1], None, SIZES)],
    "partial_mask": [(_clip(8, 2), np.array([1, 1, 0, 1, 0, 0, 1, 1], bool),
                      SIZES)],
    "not_power_of_two": [(_clip(6, 3), None, SIZES)],
    "not_slot_multiple": [(_clip(10, 4), None, SIZES)],
    "single_frame": [(_clip(1, 5)[0], None, SIZES)],
    "at_working_size": [(_clip(5, 6), None, [(W, H), (16, 9)])],
    "back_to_back": [(_clip(7, 7), None, SIZES), (_clip(7, 8)[::-1], None,
                                                   SIZES)],
    "new_frame_shape": [(_clip(5, 9), None, SIZES),
                        (_clip(3, 10, 48, 30), None, SIZES)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_equals_pageable_upload(small_slots, case):
    ring = StagingRing("cpu")
    got = [ring.stage(select_frames(g, m), s) for g, m, s in CASES[case]]
    for (works, n_real), (gray, mask, sizes) in zip(got, CASES[case]):
        want, want_n = _old_works(gray, mask, sizes)
        assert n_real == want_n
        for w, v in zip(works, want):
            assert w.dtype == v.dtype and torch.equal(w, v)
    assert len(ring.slots[0]) == (base.STAGE_SLOT_BYTES
                                  // ring.slots[0][0].numel())
    assert not ring.slots[0].is_pinned()


@pytest.fixture
def memo_engines(monkeypatch):
    """Each engine's dense pass computed once per input: a second detector
    fed the same work batches costs almost nothing, and one fed others
    computes its own."""
    run, seen = CascadeEngine.detect_raw, {}

    def detect_raw(self, work):
        key = (id(self), tuple(work.shape), work.numpy().tobytes())
        if key not in seen:
            seen[key] = run(self, work)
        return seen[key]

    monkeypatch.setattr(CascadeEngine, "detect_raw", detect_raw)


def _faces(out):
    return [[(f.id, f.rect()) for f in fs] for fs in out]


@pytest.mark.parametrize("every,reverse", [(4, False), (4, True), (2, False),
                                           (3, True)])
def test_face_process_unchanged(small_slots, memo_engines, every, reverse):
    """Two consecutive calls of one stream, of 5 and 3 frames: sub-batches
    that the ring pads on the device, x of 2 and 3 among them."""
    clip = face_clip(8, 320, 180, seed=5)
    clip = clip[::-1] if reverse else clip
    cfg = FaceDetectorConfig(process_x_every_4_frames=every)
    new = FaceDetector((320, 180), cfg, device="cpu")
    old = FaceDetector((320, 180), cfg, device="cpu")
    old._ring = PageableUpload("cpu")
    for part in (clip[:5], clip[5:]):
        got = _faces(new.process(part))
        assert got == _faces(old.process(part))
    assert any(got)


def test_eye_process_unchanged(small_slots, memo_engines):
    """A face whose two eyes the engines find: faces at 100x56, eyes at
    200x112."""
    gen = torch.Generator().manual_seed(1)
    frame = draw_clip([dict(cx=200, cy=112, s=100, vx=1, vy=0)], (400, 225),
                      1, 6, gen, torch.device("cpu")).numpy()[0]
    cfg = EyeDetectorConfig(width_to_process=200, face_width=100)
    new = EyeDetector((400, 225), cfg, device="cpu")
    old = EyeDetector((400, 225), cfg, device="cpu")
    old._ring = PageableUpload("cpu")
    got = new.process(frame)
    assert got == old.process(frame)
    assert got[0]["eye_left"] and got[0]["eye_right"]


@pytest.mark.parametrize("enabled", [False, True])
def test_counters_count_only_while_tracing(small_slots, enabled):
    t = tracing.TRACER
    t.sections.clear()
    t.counters.clear()
    ring = StagingRing("cpu")
    t.enabled = enabled
    try:
        ring.stage(select_frames(_clip(9, 11), np.arange(9) != 4), SIZES)
    finally:
        t.enabled = False
    want = {"vca.filter.staged_frames": 8, "vca.filter.upload_chunks": 2}
    assert dict(t.counters) == (want if enabled else {})
    assert t.sections["vca.filter.upload"].count == enabled
