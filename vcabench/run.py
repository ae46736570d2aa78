"""Run one cell of the benchmark once.

    python3 vcabench/run.py --workload face720p.archive --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout of the repository, on a machine with the
NVIDIA cards the cell asks for. The cell, its configuration
(``vcabench/configs/<config>.json``) and its traffic mix
(``vcabench/traffic/<mix>.json``, whose ``kind`` names the driver in
``vcabench/drivers/``) are found by name through ``BENCHMARK.json``;
with ``--trace 1`` each per-layer metric of the cell is read by
``vcabench/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, every number the check
compared with its limit; the same numbers end standard error. Without
enough CUDA cards, without the program, or with JAX loaded once the window
has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "vcabench")
PACKAGE = "nubomedia_vca_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "nubomedia_vca_tpu")


class Refused(Exception):
    """A run that must print no result."""


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module at `path` (a metric reader, named like its metric)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT, conf["file"])
    mix = load_json(BENCH, "traffic", cell["traffic"] + ".json")
    return cell, cfg, mix


def metrics_of(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer
    ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in moved]


def set_cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the
    checkout."""
    build = os.path.join(ROOT, "build")
    os.environ["NUBOMEDIA_VCA_KERNEL_DIR"] = os.path.join(build,
                                                          "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def read_layers(bench, cell, out, units) -> tuple[dict, dict, dict]:
    """Per-layer metrics, device busy time and the breakdown from the
    traced window."""
    from vcabench.frozen import profile
    lay = out["layer"]
    tr = profile.summarize(lay["prof"], ("vcabench.process",
                                         "vcabench.survivor"),
                           lay.get("window_range", "vcabench.process"))
    ctx = dict(lay, trace=tr)
    metrics = {}
    for m in metrics_of(bench, cell, True):
        reader = load_module(os.path.join(BENCH, "metrics",
                                          m["name"] + ".py"),
                             "vcabench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    dev = {"busy_s": tr.busy_us() * 1e-6, "window_s": tr.window_us * 1e-6}
    brk = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    return metrics, dev, brk


def main(argv=None, device=None) -> int:
    """One run. `device` is for the benchmark's own CPU tests only: it
    skips the look for CUDA cards and runs the cell there."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, cfg, mix = cell_spec(bench, args.workload)
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        raise Refused(f"the program ({PACKAGE}/) is not in {ROOT}")
    set_cache_dirs()
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {cell['chips']}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    # the engine's float32 matmuls must not round through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    driver = importlib.import_module("vcabench.drivers." + mix["kind"])
    cascade_dir = os.path.join(ROOT, PACKAGE, "assets", "haarcascades")
    out = driver.run(cfg, mix, args.seed, args.seconds, bool(args.trace),
                     device, cascade_dir)
    setup_s = out["t_start"] - T0

    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    breakdown = None
    if args.trace:
        metrics, busy, breakdown = read_layers(bench, cell, out, units)
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, cell, False)}
        busy = {}
    found = forbidden_modules()
    if found:
        raise Refused("loaded in this process: " + ", ".join(found))

    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in out["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(out["memory_peak_bytes"]),
                   **busy}
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT          # not the script's folder: vcabench/ only
    try:
        sys.exit(main())
    except Refused as e:
        print(f"vcabench: {e}", file=sys.stderr)
        sys.exit(3)
