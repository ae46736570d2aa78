"""The harness on the CPU: a cell and a metric added as files alone are
found and run, and the last line has the contract's keys."""

from __future__ import annotations

import pytest
import torch

from vcabench.tests import helpers

torch.set_num_threads(4)

SEED = 3_000_000_019        # above 2**31: seeds need more than 32 bits


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return helpers.tiny_tree(tmp_path_factory.mktemp("bench"))


def test_added_cell_and_metric_are_found(tree):
    run = helpers.load_run(tree)
    bench = run.load_json(tree, "BENCHMARK.json")
    cell, cfg, mix = run.cell_spec(bench, "face720p_tiny.tiny")
    assert cfg["frame"] == [320, 180] and mix["streams"] == 2
    names = [m["name"] for m in run.metrics_of(bench, cell, True)]
    assert "calls_traced.tiny" in names
    assert [m["name"] for m in run.metrics_of(bench, cell, False)] == [
        "frames_per_s", "setup_s"]


E2E = {"tiny": {"frames_per_s", "setup_s"},
       "tiny_live": {"frames_per_s", "latency_ms_p50", "latency_ms_p95",
                     "setup_s"}}
LAYER = {"tiny": {"calls_traced.tiny", "host_stage_ms.archive",
                  "survivor_ms.archive", "device_idle_share.archive"},
         "tiny_live": {"loop_step_ms.live", "frames_per_step.live",
                       "backlog_frames.live"}}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("mix", ["tiny", "tiny_live"])
def test_last_line_keys(tree, mix, trace):
    line, err = helpers.run_cell(tree, "face720p_tiny." + mix, SEED,
                                 0.5 if mix == "tiny" else 2.0, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    if trace:
        assert set(line["metrics"]) == LAYER[mix]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == E2E[mix]
        assert line["metrics"]["frames_per_s"]["unit"] == "frames/s"
    # every compared number ends stderr beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), tail):
        assert text == f"check {name}: {c['value']!r} (limit {c['limit']!r})"


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and vcabench/ prints nothing
    and exits non-zero."""
    import shutil
    import subprocess
    import sys
    root = tmp_path / "bare"
    shutil.copytree(helpers.REPO + "/vcabench", root / "vcabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(helpers.REPO + "/BENCHMARK.json", root)
    p = subprocess.run([sys.executable, "vcabench/run.py", "--workload",
                        "face720p.live", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "vcabench:" in p.stderr
