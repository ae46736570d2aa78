"""The face filter's frames whose survivors outgrow the engine's
capacities, on the CPU: with a capacity cut down so that frames with
faces overflow it, ``FaceDetector.process`` runs those frames again on
wider engines (``CascadeEngine.widened``) and equals the benchmark's
plain reference filter (``vcabench/reference/filters.py``, no capacities)
on every frame of a two-face clip, and ``vca.engine.rerun_frames`` counts
the frames run again."""

from __future__ import annotations

import json
import os

import pytest
import torch

from nubomedia_vca_tpu_torch.cascade import engine
from nubomedia_vca_tpu_torch.models.face import (FaceDetector,
                                                 FaceDetectorConfig)
from nubomedia_vca_tpu_torch.utils import tracing
from vcabench.frozen import scenes
from vcabench.reference import filters
from vcabench.tests import helpers

torch.set_num_threads(4)

CASCADES = os.path.join(helpers.REPO, helpers.PACKAGE, "assets",
                        "haarcascades")
FRAME = (320, 180)
MIX = dict(helpers.TINY_MIX, streams=1, batch=12, clip_frames=12,
           faces_per_frame=[2, 2])


@pytest.fixture(scope="module")
def clip():
    clips, _ = scenes.clips(MIX, FRAME, 2_718_281_828, torch.device("cpu"))
    return clips[0].numpy()


@pytest.fixture(scope="module")
def want(clip):
    with open(os.path.join(helpers.REPO, "vcabench", "configs",
                           "face720p.json")) as f:
        cfg = dict(json.load(f), frame=list(FRAME))
    flt = filters.FaceFilter(cfg, CASCADES, "cpu")
    out = flt.track(0, flt.detect(clip))
    assert sum(len(faces) for faces in out) >= len(clip)
    return out


# a raw-candidate capacity of 2 (read at every call), or a survivor
# capacity of 112 a level and block (read when an engine is built)
@pytest.mark.parametrize("name,cap", [("RAW_GROUP_CAP", 2),
                                      ("MAX_CAPACITY", 112)])
def test_overflowing_frames_run_again(clip, want, monkeypatch, name, cap):
    monkeypatch.setattr(engine.CascadeEngine, name, cap)
    monkeypatch.setattr(engine, "_ENGINE_CACHE", {})
    det = FaceDetector(FRAME, FaceDetectorConfig(), device="cpu")
    t = tracing.TRACER
    t.enabled = True
    try:
        got = det.process(clip)
        flagged = t.counters["vca.engine.overflow_frames"]
        reruns = t.counters["vca.engine.rerun_frames"]
    finally:
        t.enabled = False
        t.sections.clear()
        t.counters.clear()
    assert [[f.rect() + (f.id,) for f in faces] for faces in got] == want
    assert 0 < flagged <= reruns
