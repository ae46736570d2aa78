"""``Tracker.process`` against the benchmark's plain reference
(``vcabench/reference/tracker.py``, segmentMotion and __join_objects as
the element computes them) on the CPU, frame for frame, order included:

* on the motion archive footage (``vcabench/frozen/motion.py``) at
  160x90, both streams, clips played forward then backward;
* on a clip with more seeded components than the JAX package's
  ``TrackerConfig.max_blobs``, where the moving object's root comes after
  them in raster order;
* on a clip where the raster order of the components' first seed pixels
  differs from that of their roots (an object moving down, its older
  trail above another object's seeds);

and the motion archive cell run end to end through ``vcabench/run.py`` at
that size: ``correct`` with the program, not correct with the reference
computed with its MHI in bfloat16 in the program's place (the control).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.tracker import \
    TrackerConfig as JaxTrackerConfig
from nubomedia_vca_tpu_torch.models.tracker import Tracker, TrackerConfig
from nubomedia_vca_tpu_torch.utils import tracing
from vcabench.drivers import motion_archive
from vcabench.reference import tracker as ref
from vcabench.tests import helpers

torch.set_num_threads(4)

REPO = helpers.REPO
W, H = 160, 90
SEED = 3_000_000_019            # above 2**31: seeds need more than 32 bits
TINY_MIX = {"kind": "motion_archive", "streams": 2, "batch": 24,
            "clip_frames": 24, "objects_per_frame": [4, 5],
            "object_size": [10, 30], "speed_px": [1, 3],
            "flicker_per_frame": [6, 10], "flicker_size": [2, 4],
            "flicker_step": [30, 60], "noise": 6, "preroll_rounds": 3,
            "trace_calls": 1}


def _cfg() -> dict:
    with open(os.path.join(REPO, "vcabench", "configs",
                           "tracker720p.json")) as f:
        return dict(json.load(f), frame=[W, H])


def _program(**kw) -> Tracker:
    return Tracker((W, H), TrackerConfig(**kw), fps=30, device="cpu")


def _seeded(tracker: Tracker, frames, stream=0) -> tuple[list, int]:
    """`tracker.process` with the tracer on → (blobs, seeded components
    the frames gave)."""
    t = tracing.TRACER
    t.enabled = True
    try:
        out = tracker.process(frames, stream=stream)
        return out, t.counters["vca.tracker.blobs_seeded"]
    finally:
        t.enabled = False
        t.sections.clear()
        t.counters.clear()


def _boxes(frames: int, objects) -> np.ndarray:
    """[frames, H, W] uint8: flat 100, each object (x, y, w, h, vx, vy)
    a 200 box at its place in each frame."""
    clip = np.full((frames, H, W), 100, np.uint8)
    for t in range(frames):
        for x, y, w, h, vx, vy in objects:
            clip[t, y + vy * t:y + vy * t + h, x + vx * t:x + vx * t + w] = 200
    return clip


def test_process_equals_reference_on_archive_footage():
    from vcabench.frozen import motion
    clips, _ = motion.clips(TINY_MIX, (W, H), SEED, torch.device("cpu"))
    pool = clips.numpy()
    prog, want = _program(), ref.TrackerFilter(_cfg(), "cpu")
    n = seeded = 0
    for k in range(4):                  # both streams, forward then back
        s = k % 2
        frames = pool[s] if k < 2 else pool[s][::-1]
        got, c = _seeded(prog, frames, stream=s)
        assert got == want.process(s, frames)
        n, seeded = n + sum(len(b) for b in got), seeded + c
    assert n >= 4 * 24 and seeded > 3 * n   # most flicker is filtered


def test_every_seeded_component_past_max_blobs():
    """40 one-frame specks above a mover: more seeded components than
    `max_blobs`, the mover's root after all of theirs."""
    rng = np.random.RandomState(7)
    clip = _boxes(6, [(20, 60, 14, 14, 4, 0)])
    for t in (2, 3):
        for _ in range(40):
            y, x = rng.randint(0, 40), rng.randint(0, W - 2)
            clip[t, y:y + 2, x:x + 2] = 255
    got, seeded = _seeded(_program(), clip)
    want = ref.TrackerFilter(_cfg(), "cpu").process(0, clip)
    assert got == want
    assert all(len(b) == 1 for b in want[1:])      # the mover, every frame
    assert seeded > 2 * JaxTrackerConfig().max_blobs


def test_blobs_in_first_seed_order():
    """A square moving down keeps its older trail above the first row of
    its seeds; a square moving right has its seeds in between, far
    enough away that the two are not merged. segmentMotion gives the
    second first."""
    clip = _boxes(10, [(10, 10, 24, 24, 0, 6), (100, 40, 24, 24, 4, 0)])
    got = _program().process(clip)
    want = ref.TrackerFilter(_cfg(), "cpu").process(0, clip)
    assert got == want
    assert [b[0] >= 100 for b in want[8]] == [True, False]


# --------------------------------------------------- the cell, end to end
@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> str:
    """A checkout with the cell `tracker_tiny.tiny_motion`: the tracker
    configuration at 160x90 under TINY_MIX, added as files, and the
    tracker's per-layer metrics reported in it."""
    root = os.path.join(str(tmp_path_factory.mktemp("bench")), "checkout")
    shutil.copytree(os.path.join(REPO, "vcabench"),
                    os.path.join(root, "vcabench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, helpers.PACKAGE),
               os.path.join(root, helpers.PACKAGE))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "vcabench", "configs", "tracker_tiny.json"),
              "w") as f:
        json.dump(dict(_cfg(), name="tracker_tiny"), f)
    with open(os.path.join(root, "vcabench", "traffic", "tiny_motion.json"),
              "w") as f:
        json.dump(TINY_MIX, f)
    cell = "tracker_tiny.tiny_motion"
    bench["configs"].append({"name": "tracker_tiny", "source": "test",
                             "file": "vcabench/configs/tracker_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "tracker_tiny",
                               "traffic": "tiny_motion", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if "tracker720p.motion_archive" in m.get("workloads", []):
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _run_cell(root: str, seconds: float, trace: int) -> dict:
    """One CPU run of the tiny cell through the checkout's run.py → its
    last line. The suite's conftest has loaded JAX in this process, which
    run.py refuses (its runs never load it): the test lifts that guard."""
    mod = helpers.load_run(root)
    mod.forbidden_modules = lambda: []
    tracing.TRACER.counters.clear()     # the counters of this run alone
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert mod.main(["--workload", "tracker_tiny.tiny_motion", "--seed",
                         str(SEED), "--seconds", str(seconds), "--trace",
                         str(trace)], device="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


class ReferenceProgram:
    """The reference with its MHI in bfloat16, in the program's place."""

    def __init__(self, cfg, device):
        self.flt = ref.TrackerFilter(cfg, device, torch.bfloat16)

    def process(self, frames, stream=0):
        return self.flt.process(stream, frames)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct(tree, trace):
    line = _run_cell(tree, 1.0, trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["frames_differing_pct"]["value"] == 0.0
    if trace:
        assert {"segment_ms.tracker", "seg_iterations.tracker",
                "blobs_seeded.tracker", "device_idle_share.tracker"} == \
            set(line["metrics"])    # no device time: no roofline here
        assert line["metrics"]["blobs_seeded.tracker"]["value"] > 10


def test_control_is_not_correct(tree, monkeypatch):
    """The MHI in bfloat16 rounds the timestamps: past about 4 s of a
    stream's clock (the tiny mix's pre-roll takes 4.8 s) adjacent ones
    collide or part, and the blobs differ."""
    monkeypatch.setattr(motion_archive, "_program", ReferenceProgram)
    line = _run_cell(tree, 1.0, 0)
    c = line["checks"]["frames_differing_pct"]
    assert line["correct"] is False and c["value"] > c["limit"]
