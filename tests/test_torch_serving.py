"""The port's serving plane against the JAX package on the CPU.

* Host modules, exactly: wire strings and their parsing, the events-ms
  rate limiter on an injected clock, the knob registry (``apply_knobs``,
  ``clamp``), ``Tracer.report``, ``FrameBatch``, the port's
  ``PythonIngest`` against the JAX package's (frames, pts, stream ids,
  color retention, ``set_work`` downscale, drop-oldest), the port's
  ``NativeIngest`` (its own copy of ``vca_ingest.cpp``, the JAX package's
  C interface plus the queue-wait sums, built with g++ into a temporary
  build directory) against its ``PythonIngest``, and
  ``StreamFeeder`` padding.
* The filter chain: ``VcaPipeline`` (tracker → motion-gated face) and
  ``MediaPipeline`` + ``NuboFaceDetector`` + event-gated
  ``NuboNoseDetector`` at 320x240, ``widthToProcess(160)``, through the
  media loop's thread: events, wire strings and annotated frames equal the
  JAX objects' on the same clip (the nose, not the eye: the JAX eye engines
  take minutes to compile). The JAX chain's tracker keeps 128 components
  a frame, past the clip's 74, since the port's keeps every one.
* Remote objects: the learned detector's int8 ⇄ bf16 swap keeps its
  tracks, live ``setThreshold``/``setMultiScale``, and
  ``CnnFaceDetector.reconfigure`` against the JAX detector's; the learned
  part detector against JAX on ``cnn_parts_v2.npz`` (bf16: raw output within
  ``BF16_ATOL`` of jitted JAX, equal boxes).
* The IDL and the generated clients are byte-identical to the JAX
  package's and to ``clients/``; the CLI prints the JAX CLI's rects, and its
  default device raises on a host without CUDA.

Every port object is built with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import os
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu import cli as jcli
from nubomedia_vca_tpu.api import client_gen as jclient_gen
from nubomedia_vca_tpu.api import idl as jidl
from nubomedia_vca_tpu.api import media_loop as jmedia_loop
from nubomedia_vca_tpu.api import objects as jobjects
from nubomedia_vca_tpu.core import frames as jframes
from nubomedia_vca_tpu.cpp import ingest_binding as jingest
from nubomedia_vca_tpu.models import cnn as jcnn
from nubomedia_vca_tpu.models import cnn_parts as jcnn_parts
from nubomedia_vca_tpu.models.face import FaceDetector as JaxFace
from nubomedia_vca_tpu.models.face import FaceDetectorConfig as JaxFaceConfig
from nubomedia_vca_tpu.models.tracker import Tracker as JaxTracker
from nubomedia_vca_tpu.models.tracker import TrackerConfig as JaxTrackerConfig
from nubomedia_vca_tpu.pipeline import events as jevents
from nubomedia_vca_tpu.pipeline import graph as jgraph
from nubomedia_vca_tpu.pipeline import scheduler as jscheduler
from nubomedia_vca_tpu.utils import config as jconfig
from nubomedia_vca_tpu.utils import tracing as jtracing
from nubomedia_vca_tpu_torch import cli as pcli
from nubomedia_vca_tpu_torch.api import (client_gen, idl, media_loop, objects,
                                         rpc)
from nubomedia_vca_tpu_torch.core import frames
from nubomedia_vca_tpu_torch.cpp import ingest_binding
from nubomedia_vca_tpu_torch.models import cnn_parts
from nubomedia_vca_tpu_torch.models.cnn import CnnFaceDetector
from nubomedia_vca_tpu_torch.models.face import (FaceDetector,
                                                 FaceDetectorConfig)
from nubomedia_vca_tpu_torch.models.quant import QuantizedCnnFaceDetector
from nubomedia_vca_tpu_torch.models.tracker import Tracker
from nubomedia_vca_tpu_torch.pipeline import events, graph, scheduler
from nubomedia_vca_tpu_torch.utils import config, tracing
from nubomedia_vca_tpu_torch.utils.synth import (blob_clip, face_clip,
                                                 profile_scene)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 320, 240
# bf16 forward vs jitted JAX (the rule of tests/test_torch_cnn.py)
BF16_ATOL = 0.0625


def _astuples(dets):
    return [dataclasses.astuple(d) for d in dets]


# ------------------------------------------------------------- host modules
def test_wire_strings_and_parsing_match_jax():
    rng = np.random.RandomState(0)
    rects = [tuple(int(v) for v in rng.randint(0, 500, 4))
             for _ in range(5)]
    dets = [events.Detection("face", *r, id=i) for i, r in enumerate(rects)]
    jdets = [jevents.Detection("face", *r, id=i)
             for i, r in enumerate(rects)]
    wire = events.to_wire_string(dets)
    assert wire == jevents.to_wire_string(jdets)
    assert wire.count(";") == 5
    for s in (wire, "x:1,y:2;;width:3,height:4;", ""):
        assert _astuples(events.parse_wire_string(s, "eye")) == \
            _astuples(jevents.parse_wire_string(s, "eye"))
    ev = events.DetectionEvent("face", 7, tuple(dets))
    jev = jevents.DetectionEvent("face", 7, tuple(jdets))
    assert ev.boxes({"face"}) == jev.boxes({"face"}) == rects
    assert ev.boxes({"eye"}) == jev.boxes({"eye"}) == []


def test_rate_limiter_matches_jax():
    times = [0.0, 0.010, 0.020, 0.0305, 0.031, 0.5, 0.5, 0.531, 0.532]

    def clock_of(seq):
        it = iter(seq)
        return lambda: next(it)

    for events_ms in (0, 10, 30, 30001):
        port = events.EventRateLimiter(events_ms, clock=clock_of(times))
        jax_ = jevents.EventRateLimiter(events_ms, clock=clock_of(times))
        got = [port.ready() for _ in times]
        assert got == [jax_.ready() for _ in times]
        assert got[0]


@pytest.mark.parametrize("knobs", ["COMMON_KNOBS", "FACE_KNOBS",
                                   "TRACKER_KNOBS"])
def test_apply_knobs_and_clamp_match_jax(knobs, tmp_path):
    pk, jk = getattr(config, knobs), getattr(jconfig, knobs)
    assert [dataclasses.astuple(k) for k in pk] == \
        [dataclasses.astuple(k) for k in jk]
    rng = np.random.RandomState(3)
    values = {k.name: int(rng.randint(k.lo - 50, min(k.hi, 1 << 20) + 50))
              for k in pk}

    @dataclasses.dataclass
    class Cfg:
        pass

    pcfg, jcfg = Cfg(), Cfg()
    config.apply_knobs(pcfg, pk, values)
    jconfig.apply_knobs(jcfg, jk, values)
    assert vars(pcfg) == vars(jcfg)
    assert all(k.lo <= getattr(pcfg, k.attr) <= k.hi for k in pk)
    assert [config.clamp(k, v) for k, v in zip(pk, values.values())] == \
        [jconfig.clamp(k, v) for k, v in zip(jk, values.values())]
    path = tmp_path / "cfg.json"
    path.write_text('{"%s": 1}' % pk[0].name)
    config.load_config_file(pcfg, pk, str(path))
    jconfig.load_config_file(jcfg, jk, str(path))
    assert vars(pcfg) == vars(jcfg)
    for mod, ks in ((config, pk), (jconfig, jk)):
        with pytest.raises(KeyError):
            mod.apply_knobs(Cfg(), ks, {"no-such-knob": 1})


def test_tracer_report_matches_jax():
    port, jax_ = tracing.Tracer(), jtracing.Tracer()
    for t in (port, jax_):
        with t.trace("feeder/collect"):
            pass
        t.count("feeder/frames", 3)
        t.count("feeder/frames")
        t.enabled = False
        with t.trace("off"):
            pass
        # fixed stats, so the report's numbers do not depend on timing
        t.sections["feeder/collect"].total_s = 0.0125
        t.sections["feeder/collect"].max_s = 0.01
        t.sections["loop/step"].count = 4
        t.sections["loop/step"].total_s = 0.5
        t.sections["loop/step"].max_s = 0.25
    assert port.report() == jax_.report()
    assert "off" not in port.sections
    assert port.counters["feeder/frames"] == 4


def test_device_profile_writes_a_chrome_trace(tmp_path):
    with tracing.device_profile(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof.key_averages()
    assert [p.suffix for p in tmp_path.iterdir()] == [".json"]


def test_frame_batch_matches_jax():
    rng = np.random.RandomState(5)
    gray = rng.randint(0, 256, (3, 6, 7)).astype(np.uint8)
    bgr = rng.randint(0, 256, (3, 6, 7, 3)).astype(np.uint8)
    bgra = rng.randint(0, 256, (6, 7, 4)).astype(np.uint8)
    cases = [("from_gray", gray, None), ("from_gray", gray[0], [9]),
             ("from_bgr", bgr, [1, 2, 3]), ("from_bgr", bgra, None),
             ("from_i420", gray, [4, 5, 6])]
    for name, x, pts in cases:
        got = getattr(frames.FrameBatch, name)(x, pts, device="cpu")
        want = getattr(jframes.FrameBatch, name)(x, pts)
        assert got.gray.device.type == "cpu"
        np.testing.assert_array_equal(got.gray.numpy(),
                                      np.asarray(want.gray))
        assert (got.color is None) == (want.color is None)
        if got.color is not None:
            np.testing.assert_array_equal(got.color.numpy(),
                                          np.asarray(want.color))
        np.testing.assert_array_equal(got.pts, want.pts)
        assert (got.batch, got.height, got.width) == \
            (want.batch, want.height, want.width)


def _ingest_script(ing, clip, bgr):
    """One sequence of pushes and collects → everything the feeder gave."""
    out = []
    ing.push(0, clip[0], 10)
    ing.push(1, clip[1], 11)
    out.append(ing.collect(4))
    ing.set_retain_color(True)
    ing.push(2, bgr[0], 12)
    ing.push(0, clip[2], 13)
    out.append(ing.collect_color(4))
    ing.set_work(20, 15)
    ing.push(1, bgr[1], 14)
    ing.push(1, clip[3], 15)
    out.append(ing.collect_color(1))
    out.append((ing.pending(),))
    out.append(ing.collect_color(4))
    ing.set_work(0, 0)
    ing.set_retain_color(False)
    for i in range(7):                 # capacity 4: drop-oldest
        ing.push(3, clip[i % len(clip)], 100 + i)
    out.append((ing.pending(), ing.dropped))
    out.append(ing.collect(8))
    out.append(ing.collect(8))         # empty
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ingest_frames():
    clip = face_clip(4, 40, 30, seed=1)
    rng = np.random.RandomState(2)
    bgr = rng.randint(0, 256, (2, 30, 40, 3)).astype(np.uint8)
    return clip, bgr


def test_python_ingest_matches_jax(ingest_frames):
    clip, bgr = ingest_frames
    got = _ingest_script(ingest_binding.PythonIngest(40, 30, 4), clip, bgr)
    want = _ingest_script(jingest.PythonIngest(40, 30, 4), clip, bgr)
    _assert_same(got, want)
    assert got[2][0].shape == (1, 15, 20)     # set_work downscale
    assert got[-3] == (4, 3)                  # 7 pushes, 3 dropped


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


def test_native_ingest_builds_outside_the_source_tree(native_lib):
    built = [p.name for p in native_lib.iterdir()]
    assert built == [ingest_binding.library_path().name]
    assert built[0].startswith("libvca_ingest_")
    src_dir = ingest_binding.SRC.parent
    assert sorted(p.name for p in src_dir.iterdir()) == ["vca_ingest.cpp"]
    with open(ingest_binding.SRC) as f, open(
            os.path.join(REPO, "nubomedia_vca_tpu", "cpp", "ingest",
                         "vca_ingest.cpp")) as g:
        port, jax_ = f.read(), g.read()
    # every C function of the JAX package's copy, signature for signature;
    # the port adds the two queue-wait sums
    sig = re.compile(r"^\w[^\n;]*\bvca_ingest_\w+\([^)]*\)", re.M)
    added = set(sig.findall(port)) - set(sig.findall(jax_))
    assert set(sig.findall(jax_)) <= set(sig.findall(port))
    assert sorted(added) == ["int64_t vca_ingest_collect_wait_ns(void* p)",
                             "int64_t vca_ingest_collected(void* p)"]
    assert isinstance(ingest_binding.make_ingest(8, 8),
                      ingest_binding.NativeIngest)


def test_native_ingest_matches_python_ingest(native_lib, ingest_frames):
    clip, bgr = ingest_frames
    native = ingest_binding.NativeIngest(40, 30, 4)
    try:
        got = _ingest_script(native, clip, bgr)
    finally:
        native.close()
    want = _ingest_script(ingest_binding.PythonIngest(40, 30, 4), clip, bgr)
    _assert_same(got, want)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_ingest_tcp_listener_and_send(native_lib, native):
    """Raw frames over TCP (one connection per stream, per-stream pts),
    and annotated bytes sent back on the stream's connection."""
    import socket

    cls = ingest_binding.NativeIngest if native \
        else ingest_binding.PythonIngest
    ing = cls(32, 24, 16)
    f0 = np.arange(32 * 24, dtype=np.uint8).reshape(24, 32)
    try:
        port = ing.listen(0, channels=1)
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(f0.tobytes() + (f0 + 7).tobytes())
            deadline = time.time() + 5
            while ing.pending() < 2 and time.time() < deadline:
                time.sleep(0.01)
            g, pts, streams = ing.collect(4)
            assert ing.send(int(streams[0]), g[1])
            back = b""
            while len(back) < f0.size:
                back += s.recv(f0.size - len(back))
        np.testing.assert_array_equal(g, np.stack([f0, f0 + 7]))
        assert pts.tolist() == [0, 1] and streams.tolist() == [0, 0]
        assert back == (f0 + 7).tobytes()
        assert not ing.send(99, g[0])          # no such connection
    finally:
        ing.stop_listen()
        ing.close()


def test_stream_feeder_pads_like_jax(native_lib, ingest_frames):
    clip, _ = ingest_frames
    port = scheduler.StreamFeeder(40, 30, batch=4, capacity=8,
                                  work=(20, 15))
    jax_ = jscheduler.StreamFeeder(40, 30, batch=4, capacity=8,
                                   work=(20, 15))
    assert isinstance(port.ingest, ingest_binding.NativeIngest)
    for f in (port, jax_):
        assert f.next_batch() is None
        for i in range(3):
            f.push(i % 2, clip[i], 20 + i)
    got, want = port.next_batch(), jax_.next_batch()
    _assert_same([got[:3]], [want[:3]])
    assert got[3] == want[3] == 3
    assert got[0].shape == (4, 15, 20)
    assert got[2].tolist() == [0, 1, 0, -1]


# ------------------------------------------------------------- filter chain
@pytest.fixture(scope="module")
def clip():
    return face_clip(8, W, H, seed=2)


def test_vca_pipeline_tracker_to_face_matches_jax(clip):
    """Tracker motion events feed the face detector's detect-event gate.
    The clip's second frame seeds 74 motion components (the face's first
    motion, not yet joined by an older trail); the port reports them all,
    so the JAX tracker is given room for them. At its default of 32 it
    drops 42, and that frame's second and third blobs come out as
    (141, 73, 60, 119) and (149, 80, 35, 10), not (115, 73, 86, 119) and
    (149, 80, 35, 27)."""
    def chain(g, tracker, face):
        return (g.VcaPipeline()
                .add(g.FilterNode("tracker", tracker, "tracker"))
                .add(g.FilterNode("face", face, "face",
                                  consumes={"tracker"})))

    port = chain(graph, Tracker((W, H), device="cpu"),
                 FaceDetector((W, H), FaceDetectorConfig(detect_event=1),
                              device="cpu"))
    jax_ = chain(jgraph,
                 JaxTracker((W, H), JaxTrackerConfig(max_blobs=128)),
                 JaxFace((W, H), JaxFaceConfig(detect_event=1)))
    for half in (clip[:4], clip[4:]):
        got, want = port.process(half), jax_.process(half)
        assert got.keys() == want.keys() == {"tracker", "face"}
        for name in got:
            for g, w in zip(got[name], want[name]):
                assert (g.source, g.pts) == (w.source, w.pts)
                assert _astuples(g.detections) == _astuples(w.detections)
    assert any(ev.detections for ev in got["tracker"])
    assert any(ev.detections for ev in got["face"])


def _norm(payload):
    return {k: [dataclasses.astuple(i) for i in v] if isinstance(v, list)
            else v for k, v in payload.items()}


def _serve_face_nose(objs, loop, clip, device_kw):
    """MediaPipeline + face + event-gated nose through the media loop's
    thread: the clip is queued before the loop starts, so it runs in two
    batches of 4 on every host. → (events in order, annotated frames)."""
    pipe = objs.MediaPipeline((W, H), **device_kw)
    face = objs.NuboFaceDetector(pipe)
    nose = objs.NuboNoseDetector(pipe)
    nose.detectByEvent(1)
    nose.widthToProcess(160)
    got_events, annotated = [], []
    for el, name in ((face, "OnFace"), (nose, "OnNose")):
        el.activateServerEvents(1, 0)
        # one second per call: every non-empty frame passes events-ms 0
        el._rate = type(el._rate)(0, clock=itertools.count().__next__)
        el.addEventListener(name, lambda p: got_events.append(_norm(p)))
    runner = loop.MediaRunner(pipe, batch=4)
    pipe._runner = runner
    runner.on_annotated = lambda out, stream: annotated.append(out.copy())
    try:
        for i, fr in enumerate(clip):
            runner.ingest.push(0, fr, i)
        runner._start()
        deadline = time.time() + 600
        while pipe.framesProcessed() < len(clip) and time.time() < deadline:
            time.sleep(0.02)
        stats = pipe.getStats()
    finally:
        pipe.stopMedia()
    assert stats["framesProcessed"] == len(clip) and stats["dropped"] == 0
    return got_events, np.concatenate(annotated)


def test_media_pipeline_face_nose_matches_jax(clip):
    got_ev, got_frames = _serve_face_nose(objects, media_loop, clip,
                                          {"device": "cpu"})
    want_ev, want_frames = _serve_face_nose(jobjects, jmedia_loop, clip, {})
    assert got_ev == want_ev
    assert {e["type"] for e in got_ev} == {"OnFace", "OnNose"}
    assert all(e["wire"].count(";") >= 1 for e in got_ev)
    np.testing.assert_array_equal(got_frames, want_frames)
    assert (got_frames != clip).any()          # boxes were drawn


def test_listen_rejects_gray_output_with_downscale():
    pipe = objects.MediaPipeline((W, H), device="cpu")
    objects.NuboFaceDetector(pipe)
    try:
        with pytest.raises(ValueError):
            pipe.listen(0, channels=1, output=1, downscale=1)
    finally:
        pipe.stopMedia()


@pytest.mark.parametrize("make", [
    lambda: objects.MediaPipeline((W, H)),
    lambda: rpc.VcaRpcServer(port=0),
    lambda: cnn_parts.CnnPartDetector((W, H)),
    lambda: frames.FrameBatch.from_gray(np.zeros((1, 4, 4), np.uint8)),
], ids=["MediaPipeline", "VcaRpcServer", "CnnPartDetector", "FrameBatch"])
def test_serving_entry_points_default_to_cuda(make):
    """Without a device argument they run on the card: on a host without
    CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        make()


# ----------------------------------------------------------- remote objects
def test_cnn_quantized_swap_keeps_tracks(clip):
    pipe = objects.MediaPipeline((W, H), device="cpu")
    det = objects.NuboCnnFaceDetector(pipe)
    first = det.process(clip[:4])
    m1 = det._ensure_model()
    tracks, counter = m1.tracks, m1.gop.counter
    det.setQuantized(1)
    m2 = det._ensure_model()
    assert isinstance(m2, QuantizedCnnFaceDetector)
    assert m2.tracks is tracks and m2.gop.counter == counter == 4
    assert m2.device == pipe.device
    again = det.process(clip[4:])
    assert {f.id for fs in first for f in fs} & \
        {f.id for fs in again for f in fs}
    det.setThreshold(0.7)
    assert det._ensure_model() is m2 and m2.threshold == 0.7
    det.setMultiScale(1)
    assert det._ensure_model() is m2 and m2.multi_scale is True
    det.setQuantized(0)
    m3 = det._ensure_model()
    assert type(m3) is CnnFaceDetector and m3.tracks is tracks


def test_cnn_reconfigure_matches_jax():
    """The same knobs on live detectors: equal boxes and track ids after,
    tracks, GOP clock and gate budget kept."""
    frames = face_clip(8, 640, 480, seed=4)
    port = CnnFaceDetector((640, 480), device="cpu")
    jax_ = jcnn.CnnFaceDetector((640, 480))
    ids = lambda res: [[(f.id, f.rect()) for f in fs] for fs in res]
    assert ids(port.process(frames[:4])) == ids(jax_.process(frames[:4]))
    knobs = dict(threshold=0.3, multi_scale=True, detect_event=0,
                 process_x_every_4_frames=2)
    port.reconfigure(**knobs)
    jax_.reconfigure(**knobs)
    assert (port.threshold, port.multi_scale, port.gop.x, port.gate.x) == \
        (jax_.threshold, jax_.multi_scale, jax_.gop.x, jax_.gate.x)
    assert port.gop.counter == jax_.gop.counter == 4
    got, want = ids(port.process(frames[4:])), ids(jax_.process(frames[4:]))
    assert got == want
    assert sum(len(f) for f in got) > 0
    assert port.tracks[0].next_id == jax_.tracks[0].next_id


@pytest.fixture(scope="module")
def part_detectors():
    return (cnn_parts.CnnPartDetector((640, 480), device="cpu"),
            jcnn_parts.CnnPartDetector((640, 480)))


@pytest.mark.parametrize("scene", ["faces", "profiles"])
def test_cnn_part_detector_matches_jax(part_detectors, scene):
    port, jax_ = part_detectors
    frames = face_clip(2, 640, 480, seed=2) if scene == "faces" else \
        np.stack([profile_scene(640, 480, seed=s) for s in range(2)])
    canvas = port.letterbox(torch.from_numpy(frames))
    pred = port.model(canvas).numpy()
    want = np.asarray(jax.jit(lambda g: jcnn_parts.forward(jax_.params, g))(
        canvas.numpy()))
    assert pred.shape == want.shape == (2, 15, 20, cnn_parts.C, 5)
    assert np.abs(pred - want).max() <= BF16_ATOL
    got = port.process(frames)
    assert got == jax_.process(frames)
    found = {k for r in got for k, v in r.items() if v}
    assert found >= ({"face", "eye", "nose"} if scene == "faces"
                     else {"profile", "ear"})


def test_cnn_part_detector_requires_true_f32_matmul():
    """Its float32 head refuses TF32, as the face CNN's does."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            cnn_parts.CnnPartDetector((W, H), device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_cnn_part_object_set_threshold_rebuilds(part_detectors):
    pipe = objects.MediaPipeline((640, 480), device="cpu")
    det = objects.NuboCnnPartDetector(pipe)
    m1 = det._ensure_model()
    assert m1.thresholds == tuple(cnn_parts.DEFAULT_THRESHOLDS[k]
                                  for k in cnn_parts.CLASSES)
    det.setThreshold(0.8)
    m2 = det._ensure_model()
    assert m2 is not m1 and m2.params is m1.params
    assert m2.thresholds == (0.8,) * cnn_parts.C


# ---------------------------------------------------------------------- IDL
def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_idl_and_clients_byte_identical(tmp_path):
    idl.emit_all(str(tmp_path / "idl"))
    jidl.emit_all(str(tmp_path / "jax_idl"))
    assert _tree(tmp_path / "idl") == _tree(tmp_path / "jax_idl")
    assert len(_tree(tmp_path / "idl")) == len(idl.MODULES) == 8
    client_gen.generate(str(tmp_path / "idl"), str(tmp_path / "clients"))
    jclient_gen.generate(str(tmp_path / "jax_idl"),
                         str(tmp_path / "jax_clients"))
    fresh = _tree(tmp_path / "clients")
    assert fresh == _tree(tmp_path / "jax_clients")
    assert fresh == _tree(os.path.join(REPO, "clients"))


# ---------------------------------------------------------------------- CLI
def test_cli_tracker_prints_the_jax_clis_rects(monkeypatch):
    out = subprocess.run(
        [sys.executable, "-m", "nubomedia_vca_tpu_torch", "tracker",
         "--synthetic", "--frames", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = [ln for ln in out.stdout.splitlines() if ln.startswith("frame")]
    # the JAX CLI on the same frames (the port's cv2-free blob clip)
    frames = blob_clip(4, W, H, seed=7)
    monkeypatch.setattr(jcli, "_read_frames", lambda ns: (frames, None))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(["tracker", "--synthetic", "--frames", "4"]) == 0
    want = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("frame")]
    assert got == want and len(got) == 4
    assert any("(" in ln for ln in got)


def test_cli_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="cuda"):
        pcli.main(["tracker", "--synthetic", "--frames", "1"])
