"""A copy of the benchmark with a tiny cell, for the CPU tests: the cell,
its configuration and traffic mix, and one extra metric, added as files
alone."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "nubomedia_vca_tpu_torch"

TINY_MIX = {"kind": "archive", "streams": 2, "batch": 4, "clip_frames": 4,
            "faces_per_frame": [1, 2], "face_size": [45, 65],
            "drift_px": [1, 3], "noise": 6, "trace_calls": 1}

TINY_LIVE = {"kind": "live", "cameras": 1, "fps": 10, "clip_frames": 8,
             "faces_per_frame": [1, 1], "face_size": [45, 65],
             "drift_px": [1, 1], "noise": 6, "tint": [-6, -2, 4],
             "warm_bursts": [1, 2, 3], "wait_s": 30, "check_frames": 40}

EXTRA_METRIC = '''"""calls_traced.tiny: calls in the traced window."""


def read(ctx):
    return float(ctx["calls"])
'''


def tiny_tree(tmp, config: str = "face720p") -> str:
    """A checkout in `tmp` holding BENCHMARK.json, vcabench/ and the
    program, with the cells `<config>_tiny.tiny` and
    `<config>_tiny.tiny_live` (the configuration at 320x180, the archive
    and live mixes cut down) and the per-layer metric
    ``calls_traced.tiny`` added as files."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(REPO, "vcabench"),
                    os.path.join(root, "vcabench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, PACKAGE), os.path.join(root, PACKAGE))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "vcabench", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    cfg.update(name=config + "_tiny", frame=[320, 180])
    with open(os.path.join(root, "vcabench", "configs",
                           config + "_tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "vcabench", "traffic", "tiny.json"),
              "w") as f:
        json.dump(TINY_MIX, f)
    with open(os.path.join(root, "vcabench", "traffic", "tiny_live.json"),
              "w") as f:
        json.dump(TINY_LIVE, f)
    with open(os.path.join(root, "vcabench", "metrics",
                           "calls_traced.tiny.py"), "w") as f:
        f.write(EXTRA_METRIC)
    cell = f"{config}_tiny.tiny"
    bench["configs"].append({"name": config + "_tiny", "source": "test",
                             "file": f"vcabench/configs/{config}_tiny.json",
                             "reduced": [], "why": "test"})
    live = f"{config}_tiny.tiny_live"
    bench["workloads"].append({"name": cell, "config": config + "_tiny",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["workloads"].append({"name": live, "config": config + "_tiny",
                               "traffic": "tiny_live", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" not in m:
            continue
        if any(w.endswith(".live") for w in m["workloads"]):
            m["workloads"].append(live)
        if any(".archive" in w for w in m["workloads"]) and \
                not m["name"].startswith("dense_roofline"):
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "calls_traced.tiny", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "filter loop",
        "moves": "frames_per_s", "workloads": [cell]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def load_run(root: str):
    """The checkout's own run.py as a module (its ROOT is `root`)."""
    spec = importlib.util.spec_from_file_location(
        "vcabench_run_" + str(abs(hash(root))),
        os.path.join(root, "vcabench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(root: str, cell: str, seed: int, seconds: float,
             trace: int) -> tuple[dict, str]:
    """One CPU run of `cell` → (its last stdout line, its stderr)."""
    mod = load_run(root)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()
