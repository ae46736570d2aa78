"""The port's spans and counters (``utils/tracing.py``) on the CPU.

* With tracing off a filter call or a media-loop step opens no profiler
  range; under ``torch.profiler`` the filter loop's and the engine's spans
  nest inside ``vca.filter.process``, and results do not change.
* ``vca.engine.overflow_frames`` counts the frames whose engine flag is
  set (a survivor capacity cut down so that frames overflow).
* The media loop counts the ingest's queue wait with both ingests.
* The benchmark's readers of these spans (``vcabench/metrics/``) give a
  number on a CPU trace and nothing without the spans.
* The tracker's spans and counters record only while the gate is open,
  and the motion archive cell's readers read them.
"""

from __future__ import annotations

import importlib.util
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nubomedia_vca_tpu_torch.api import media_loop, objects
from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine
from nubomedia_vca_tpu_torch.cpp import ingest_binding
from nubomedia_vca_tpu_torch.models.face import FaceDetector
from nubomedia_vca_tpu_torch.models.nose import NoseDetector
from nubomedia_vca_tpu_torch.models.tracker import Tracker
from nubomedia_vca_tpu_torch.utils import tracing
from nubomedia_vca_tpu_torch.utils.synth import face_scene
from vcabench.frozen import profile as bench_profile

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 320, 180
FILTER_SPANS = ("vca.filter.upload", "vca.filter.fetch",
                "vca.engine.dense", "vca.engine.survivor",
                "vca.engine.group", "vca.filter.track")
DETECTORS = {"face": FaceDetector, "nose": NoseDetector}


@pytest.fixture(scope="module")
def frames():
    """Four frames with a face, two without."""
    faces = [face_scene(W, H, faces=((160, 90, 60),), noise=5, seed=i)
             for i in range(4)]
    return np.stack(faces + [np.full((H, W), 128, np.uint8)] * 2)


@pytest.fixture
def tracer():
    """The global tracer, emptied, and disabled again afterwards."""
    t = tracing.TRACER
    t.sections.clear()
    t.counters.clear()
    try:
        yield t
    finally:
        t.enabled = False
        t.sections.clear()
        t.counters.clear()


def _plain(results):
    """Per-frame results → comparable tuples."""
    return [[f.rect() + (f.id,) for f in r] if isinstance(r, list)
            else sorted(r.items()) for r in results]


@pytest.fixture
def ranges_opened(monkeypatch):
    """Counts every ``record_function`` made, whoever makes it."""
    made = []
    init = torch.autograd.profiler.record_function.__init__

    def counting(self, *a, **kw):
        made.append(a[0] if a else kw.get("name"))
        init(self, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__init__", counting)
    return made


def test_tracing_off_opens_no_range(frames, tracer, ranges_opened):
    assert not tracer.enabled and not tracer.active()
    FaceDetector((W, H), device="cpu").process(frames)
    pipe = objects.MediaPipeline((W, H), device="cpu")
    objects.NuboFaceDetector(pipe)
    runner = media_loop.MediaRunner(pipe, batch=4)
    runner.on_annotated = lambda out, stream: None
    runner._step(frames)
    assert runner.frames_processed == len(frames)
    assert ranges_opened == []
    assert not tracer.sections and not tracer.counters


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_spans_nest_inside_process_under_the_profiler(frames, tracer, name):
    det = DETECTORS[name]((W, H), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det.process(frames)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("vca.")]
    (lo, hi), = [(s, e) for n, s, e in spans if n == "vca.filter.process"]
    assert {n for n, _, _ in spans} == {"vca.filter.process",
                                        *FILTER_SPANS}
    assert all(lo <= s <= e <= hi for _, s, e in spans)
    assert tracer.counters["vca.filter.frames"] == len(frames)
    assert tracer.sections["vca.filter.process"].count == 1


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_results_equal_with_tracing_on_and_off(frames, tracer, name):
    off = DETECTORS[name]((W, H), device="cpu").process(frames)
    tracer.enabled = True
    on = DETECTORS[name]((W, H), device="cpu").process(frames)
    tracer.enabled = False
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = DETECTORS[name]((W, H), device="cpu").process(frames)
    assert _plain(on) == _plain(off) == _plain(profiled)
    assert any(r for r in _plain(off))


def _engine_flags(det, frames) -> np.ndarray:
    """The overflow flag of each frame, from the engines themselves (the
    device passes pad the batch to a power of two: the flags of the
    padding rows are left out)."""
    if isinstance(det, FaceDetector):
        raw = det._device_detect(frames)
        flags = det.engine.group_device(raw, det.config.min_neighbors)[
            3].numpy()
    else:
        face_raw, part_raw = det._device_pass(frames)
        flags = face_raw[3].copy()
        for raw in part_raw.values():
            flags |= raw[2]
    return flags[:len(frames)]


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_overflow_frames_count_the_engines_flags(frames, tracer,
                                                 monkeypatch, name):
    # a raw-candidate capacity of 2: frames with a face overflow it
    monkeypatch.setattr(CascadeEngine, "RAW_GROUP_CAP", 2)
    want = int(_engine_flags(DETECTORS[name]((W, H), device="cpu"),
                             frames).sum())
    assert 0 < want < len(frames)
    tracer.enabled = True
    DETECTORS[name]((W, H), device="cpu").process(frames)
    assert tracer.counters["vca.engine.overflow_frames"] == want
    assert tracer.counters["vca.filter.frames_detected"] == len(frames)


@pytest.fixture
def native_lib(tmp_path, monkeypatch):
    """The port's ingest built with g++ into a temporary build directory."""
    monkeypatch.setenv("NUBOMEDIA_VCA_KERNEL_DIR", str(tmp_path))
    ingest_binding._load.cache_clear()
    try:
        assert ingest_binding._load() is not None
        yield tmp_path
    finally:
        ingest_binding._load.cache_clear()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_media_loop_counts_the_ingest_wait(native_lib, frames, tracer,
                                           native):
    pipe = objects.MediaPipeline((W, H), device="cpu")
    objects.NuboFaceDetector(pipe)
    runner = media_loop.MediaRunner(pipe, batch=4)
    pipe._runner = runner
    runner.ingest = (ingest_binding.NativeIngest if native
                     else ingest_binding.PythonIngest)(W, H, 64)
    runner.on_annotated = lambda out, stream: None
    tracer.enabled = True
    try:
        for i, fr in enumerate(frames):
            runner.push(fr, pts=i)
        deadline = time.time() + 120
        while runner.frames_processed < len(frames) and \
                time.time() < deadline:
            time.sleep(0.02)
    finally:
        pipe.stopMedia()
    c, s = tracer.counters, tracer.sections
    assert runner.stats()["framesProcessed"] == len(frames)
    assert c["vca.ingest.frames"] == len(frames) == runner.ingest.collected
    assert c["vca.ingest.wait_us"] >= 0
    assert c["vca.media.frames"] == len(frames)
    assert c["vca.media.steps"] == s["vca.media.step"].count
    assert s["vca.media.elements"].count == s["vca.media.emit"].count == \
        c["vca.media.steps"]
    assert s["vca.media.collect"].count >= 1


# ------------------------------------------------- the benchmark's readers
def _reader(name):
    path = os.path.join(REPO, "vcabench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(prof):
    return {"prof": prof, "trace": bench_profile.summarize(
        prof, ("vcabench.process", "vcabench.survivor"), "vcabench.process")}


@pytest.fixture(scope="module")
def traced_call(frames):
    """A face call traced as the archive cells trace theirs."""
    det = FaceDetector((W, H), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("vcabench.process"):
            det.process(frames)
    return prof


@pytest.fixture(scope="module")
def untraced_call():
    """The same kind of window without the program's spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("vcabench.process"):
            torch.ones(4, 4).sum()
    return prof


@pytest.mark.parametrize("name", ["upload_ms.archive", "track_ms.archive",
                                  "group_ms.archive"])
def test_archive_trace_readers(traced_call, untraced_call, name):
    read = _reader(name)
    got = read(_ctx(traced_call))
    assert isinstance(got, float) and got >= 0
    assert read(_ctx(untraced_call)) is None


def test_archive_counter_reader(tracer):
    read = _reader("overflow_share.archive")
    assert read({}) is None
    tracer.counters.update({"vca.filter.frames_detected": 64,
                            "vca.engine.overflow_frames": 8})
    assert read({}) == 12.5


@pytest.mark.parametrize("name,want", [("ingest_wait_ms.live", 2.5),
                                       ("elements_ms.live", 30.0),
                                       ("emit_ms.live", 5.0)])
def test_live_readers(tracer, name, want):
    read = _reader(name)
    assert read({}) is None
    tracer.counters.update({"vca.ingest.frames": 4,
                            "vca.ingest.wait_us": 10000})
    for span, total in (("vca.media.step", 0.08),
                        ("vca.media.elements", 0.06),
                        ("vca.media.emit", 0.01)):
        tracer.sections[span].count = 2
        tracer.sections[span].total_s = total
    assert read({}) == pytest.approx(want)


# ------------------------------------------------------------- the tracker
TRACKER_SPANS = ("vca.tracker.upload", "vca.tracker.segment",
                 "vca.tracker.fetch", "vca.tracker.join")


@pytest.fixture(scope="module")
def motion_clip():
    """Eight frames of a square moving right over flat grey."""
    clip = np.full((8, H, W), 100, np.uint8)
    for t in range(8):
        clip[t, 60:90, 40 + 5 * t:70 + 5 * t] = 200
    return clip


def test_tracker_spans_only_under_the_gate(motion_clip, tracer,
                                           ranges_opened):
    off = Tracker((W, H), device="cpu").process(motion_clip)
    assert ranges_opened == []
    assert not tracer.sections and not tracer.counters
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = Tracker((W, H), device="cpu").process(motion_clip)
    assert on == off and any(off)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("vca.")]
    (lo, hi), = [(s, e) for n, s, e in spans if n == "vca.tracker.process"]
    assert {n for n, _, _ in spans} == {"vca.tracker.process",
                                        *TRACKER_SPANS}
    assert all(lo <= s <= e <= hi for _, s, e in spans)
    assert sum(n == "vca.tracker.segment" for n, _, _ in spans) == 8
    c = tracer.counters
    assert c["vca.tracker.frames"] == 8
    assert c["vca.tracker.seg_iterations"] >= 8 * 4
    assert c["vca.tracker.blobs_seeded"] >= 7      # the first frame: none


@pytest.fixture
def traced_tracker_call(motion_clip, tracer):
    """A tracker call traced as the motion archive cell traces its calls,
    with the counters it left."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("vcabench.process"):
            Tracker((W, H), device="cpu").process(motion_clip)
    return prof


@pytest.mark.parametrize("name", ["segment_ms.tracker",
                                  "seg_iterations.tracker",
                                  "blobs_seeded.tracker",
                                  "device_idle_share.tracker"])
def test_tracker_readers(traced_tracker_call, untraced_call, tracer, name):
    read = _reader(name)
    got = read(_ctx(traced_tracker_call))
    assert isinstance(got, float) and got > 0
    if name == "device_idle_share.tracker":
        assert got == 100.0               # the CPU: no device activity
        return
    tracer.counters.clear()
    assert read(_ctx(untraced_call)) is None


class _Event:
    def __init__(self, name, device_us):
        self.name, self.device_time_total = name, device_us
        self.device_type = torch.autograd.DeviceType.CPU


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_step_roofline_reader(traced_tracker_call):
    read = _reader("step_roofline.tracker")
    ctx = {"calls": 2, "pool": np.zeros((16, 64, 1, 1), np.uint8),
           "cfg": {"frame": [1280, 720]}}
    # 128 frames of 11 B a pixel at 3.35 TB/s: 387.2 µs against 1 s
    prof = _Prof([_Event("vca.tracker.process", 6e5), _Event("x", 9e9),
                  _Event("vca.tracker.process", 4e5)])
    assert read(dict(ctx, prof=prof)) == pytest.approx(
        100 * 128 * 11 * 1280 * 720 / 3.35e12)
    # no device time inside the ranges (a CPU trace, or the parent's
    # program without them): nothing to read
    assert read(dict(ctx, prof=traced_tracker_call)) is None
    assert read(dict(ctx, prof=_Prof([]))) is None


def test_rerun_share_reader(tracer):
    read = _reader("rerun_share.archive")
    tracer.counters.update({"vca.filter.frames_detected": 64})
    assert read({}) is None               # a program that never re-runs
    tracer.counters["vca.engine.rerun_frames"] = 0
    assert read({}) == 0.0
    tracer.counters["vca.engine.rerun_frames"] = 16
    assert read({}) == 25.0
