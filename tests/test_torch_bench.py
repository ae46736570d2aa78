"""``bench_torch.py``, the port's benchmark script, against ``bench.py`` on
the CPU: the grouped and raw steps equal ``bench._steps`` on a JAX engine,
the int8 CNN step equals the JAX detector's ``_device_detect_int8``, the
chain step equals the port's detectors' device passes, the host side
(tracking and event strings) equals ``bench._host_side_factory``; the
face engine's bytes a frame equal a count by hand; the headline order is
``bench.py``'s; ``main()`` raises without a card, reports a failed phase
and runs the later ones. ``bench.py`` is loaded by path (it imports only
numpy at top level).
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
from nubomedia_vca_tpu.cascade.engine import CascadeEngine as JaxEngine
from nubomedia_vca_tpu.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu_torch.models import (EyeDetector, FaceDetector,
                                            MouthDetector, NoseDetector)
from nubomedia_vca_tpu_torch.models.face import DEFAULT_FACE_CASCADE

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA_ONLY = "face_detect_720p_fps_per_chip_xla_only"


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench_jax", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def frames():
    """B=2 of the bench's 1280x720 frames, made with numpy from seed 0."""
    return bt.make_frames(2)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grouped_and_raw_steps_equal_bench_py(bench, frames):
    eng, step_raw, step_grouped = bt.grouped_steps("cpu")
    jeng = JaxEngine(load_cascade_xml(DEFAULT_FACE_CASCADE),
                     (bt.WORK_W, eng.image_h), 1.25)
    j_raw, j_grouped = bench._steps(jeng, eng.image_h)
    x, jx = torch.from_numpy(frames), jnp.asarray(frames)
    raw = step_raw(x)
    _equal(raw, j_raw(jx))
    _equal(step_grouped(x), j_grouped(jx))
    assert int(raw[1].sum()) > 0


def test_int8_step_equals_jax_detector(frames):
    from nubomedia_vca_tpu.models import quant as jquant

    det = bt.cnn_detectors("cpu")["cnn_int8_720p_fps"]
    boxes, _, kept = det.detect_device(torch.from_numpy(frames))
    jd = jquant.QuantizedCnnFaceDetector((bt.W, bt.H))
    j_boxes, _, j_kept = jax.jit(jd._device_detect_int8)(jnp.asarray(frames))
    kept = kept.numpy()
    np.testing.assert_array_equal(kept, np.asarray(j_kept))
    np.testing.assert_array_equal(boxes.numpy()[kept],
                                  np.asarray(j_boxes)[kept])
    assert kept.sum() > 0


def test_chain_step_equals_detectors_device_passes(frames):
    """At B=1: the face pass equals FaceDetector's engine grouped at
    minNeighbors 3, each part engine's compacted candidates the part
    detector's own device pass (both held against JAX by
    tests/test_torch_{parts,eye}.py)."""
    x = frames[:1]
    engines, step = bt.chain_step("cpu")
    faces, parts = step(torch.from_numpy(x))
    fd = FaceDetector((bt.W, bt.H), device="cpu")
    _equal(faces, [t.numpy() for t in fd.engine.group_device(
        fd._device_detect(x), bt.MIN_NEIGHBORS)])
    names = []
    for cls in (EyeDetector, MouthDetector, NoseDetector):
        _, part_raw = cls((bt.W, bt.H), device="cpu")._device_pass(x)
        for name, want in part_raw.items():
            _equal(parts[name], want)
            names.append(name)
    assert sorted(names) == sorted(parts) and len(engines) == 1 + len(names)
    assert sum(int(v.sum()) for _, v, _ in parts.values()) > 0


def _grouped_outputs(rng, DB, n_streams, k):
    """Synthesized grouped outputs in 160-wide pixels: per stream a face
    drifting a pixel a batch, some frames empty, some with a second
    box."""
    boxes = np.zeros((DB, 64, 4), np.float32)
    valid = np.zeros((DB, 64), bool)
    for b in range(DB):
        s = b % n_streams
        n = rng.choice([0, 1, 1, 2])
        for j in range(n):
            boxes[b, j] = [10 + 7 * s + k + 40 * j + rng.randint(0, 3),
                           20 + rng.randint(0, 3), 25 + rng.randint(0, 4),
                           25 + rng.randint(0, 4)]
            valid[b, j] = True
    return boxes, valid


def test_host_side_equals_bench_py(bench, monkeypatch):
    from nubomedia_vca_tpu.models import face as jface

    seen = []

    class Recording(jface.FaceTracks):
        def update(self, detections, track_threshold):
            faces = super().update(detections, track_threshold)
            seen.append([(f.x, f.y, f.w, f.h) for f in faces])
            return faces

    monkeypatch.setattr(jface, "FaceTracks", Recording)
    jax_side = bench._host_side_factory(bt.N_STREAMS)
    port = bt.HostSide()
    rng = np.random.RandomState(1)
    DB = 40
    for k in range(6):
        boxes, valid = _grouped_outputs(rng, DB, bt.N_STREAMS, k)
        seen.clear()
        jax_side((boxes, valid, np.ones((DB, 64), np.float32),
                  np.zeros((DB,), bool)))
        got = port(boxes, valid)
        assert got == ["".join(f"x:{x},y:{y},width:{w},height:{h};"
                               for x, y, w, h in faces)
                       for faces in seen if faces]
    state = inspect.getclosurevars(jax_side).nonlocals
    assert port.events == state["events"][0] > 0
    for p, j in zip(port.tracks, state["tracks"]):
        assert [(f.id, f.rect()) for f in p.faces] == \
            [(f.id, (f.x, f.y, f.w, f.h)) for f in j.faces]
        assert p.next_id == j.next_id


def _src_rows(src, dst, r0, r1):
    """Source rows that INTER_LINEAR_EXACT rows r0..r1-1 read: output row y
    sits at ((2y+1) src - dst) / (2 dst) and reads the row below it and the
    next, clamped."""
    if src == dst:
        return r1 - r0
    y = np.arange(r0, r1)
    s0 = np.clip(np.floor(((2 * y + 1) * src - dst) / (2 * dst)), 0, src - 1)
    return len(set(s0.tolist()) | set(np.minimum(s0 + 1, src - 1).tolist()))


def test_face_engine_bytes_equal_a_hand_count():
    eng, _, _ = bt.grouped_steps("cpu")
    # frontalface_alt at 160x90, factor 1.25: (sw, sh, nx, ny)
    levels = [(160, 90, 71, 36), (128, 72, 55, 27), (102, 58, 42, 20),
              (82, 46, 32, 14), (66, 37, 47, 18), (52, 29, 33, 10),
              (42, 24, 23, 5)]
    assert [(l.sw, l.sh, l.nx, l.ny) for l in eng.levels] == levels
    assert eng.routes == ["pyramid"] * 7
    # the pyramid kernel's bands: (level, first level row, level rows with
    # the halo)
    bands = [(0, 0, 36), (0, 18, 36), (0, 36, 36), (0, 54, 36), (1, 0, 36),
             (1, 18, 36), (1, 36, 36), (2, 0, 38), (2, 20, 38), (3, 0, 46),
             (4, 0, 37), (5, 0, 29), (6, 0, 24)]
    assert [(li, r0, rows) for li, _, _, r0, rows, _
            in eng._plan.items.tolist()] == bands
    # survivor slots: the first compaction's and the last block's
    caps = [(1151, 205), (669, 119), (378, 68), (202, 64), (381, 68),
            (149, 64), (64, 64)]
    assert [(c[0], c[-1]) for c in eng._level_caps] == caps
    want = _src_rows(720, 90, 0, 90) * 1280 + 160 * 90   # resize to 160x90
    want += 2 * 160 * 90                                  # equalize
    want += sum(_src_rows(90, levels[li][1], r0, r0 + rows) * 160
                for li, r0, rows in bands)               # kernel reads
    for (sw, sh, nx, ny), (cap0, last) in zip(levels, caps):
        img = sw * sh
        want += (img if sh != 90 else 0) + 5 * nx * ny   # kernel writes
        want += 5 * nx * ny + min(cap0 * 20 * 20, img)   # survivor reads
        want += 17 * last                                # raw candidates
    want += 17 * sum(last for _, last in caps)           # grouping reads
    want += 64 * (16 + 1 + 4) + 1                        # grouped written
    assert bt.frame_bytes(eng) == want
    assert bt.hbm_share(bt.HBM_GBPS) == 1.0
    with pytest.raises(bt.BenchError, match="byte count"):
        bt.hbm_share(1.06 * bt.HBM_GBPS)


def test_headline_keys_are_bench_pys_without_xla_only(bench):
    src = open(os.path.join(REPO, "bench.py")).read()
    names = set(re.findall(r'"([a-z0-9_]+_(?:fps|ms_\w+|derived|est|'
                           r'per_chip|chip_\w+))"', src))
    lines = {"all": "\n".join(json.dumps({"metric": n}) for n in names)}
    order = [json.loads(ln)["metric"] for ln in bench._headline_lines(lines)]
    assert XLA_ONLY in order and order[-1] == "face_detect_720p_fps_per_chip"
    assert list(reversed(bt.HEADLINE_KEYS)) == [k for k in order
                                                if k != XLA_ONLY]
    report = bt.Report()
    for k in bt.HEADLINE_KEYS + ["device_path_720p_fps"]:
        report.lines[k] = json.dumps({"metric": k})
    assert [json.loads(ln)["metric"] for ln in report.headline_lines()] == \
        list(reversed(bt.HEADLINE_KEYS))


def test_main_raises_without_a_card(monkeypatch):
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bt, "PHASES", {name: lambda *a, name=name:
                                       ran.append(name) for name in bt.PHASES})
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        bt.main(["4"])
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        bt.main(["--phase", "grouped", "4"])
    assert ran == []


def test_main_reports_a_failed_phase_and_runs_the_rest(monkeypatch, capsys):
    """Card first, each phase's launches, the headline last; a phase that
    raises is reported on stderr, the later phases run, main returns 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bt, "gpu_line", lambda: "card, 700.00 W")
    ran = []

    def fake(name):
        def phase(B, dev, report):
            ran.append(name)
            if name == "chain":
                raise bt.BenchError("chain broke")
            for k in bt.HEADLINE_KEYS:
                report.fps(k, 1.0)
        return phase

    monkeypatch.setattr(bt, "PHASES", {n: fake(n) for n in bt.PHASES})
    assert bt.main(["4"]) == 1
    assert ran == list(bt.PHASES)
    out, err = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert lines[0]["metric"] == "card" and lines[0]["kind"] == "card"
    assert lines[-1]["metric"] == "face_detect_720p_fps_per_chip"
    assert [ln["metric"] for ln in lines if ln["metric"].endswith(
        "_launches")] == [f"{n}_launches" for n in list(bt.PHASES)]
    assert "chain broke" in err and "phases failed: ['chain']" in err


def test_script_imports_no_jax_and_needs_a_card():
    code = ("import sys\nimport bench_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nubomedia_vca_tpu', 'tests', 'cv2')]\n"
            "assert not bad, bad\nprint('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "bench_torch.py", "4"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "NVIDIA GPU" in out.stderr
