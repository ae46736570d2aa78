"""The sweep that sets a live cell's camera count, on the chip.

    python3 vcabench/sweep.py --workload face720p.live --seed 5 \
        --seconds 20 --cameras 1,2,3,4,6,8,12,16

Runs the cell's live mix once for each camera count, with no check, and
prints one JSON line each: frames/s, the latency median and 95th
percentile, the median of each half of the window, frames lost (dropped
at the ingest, dropped on the way back, never returned), the backlog's
growth over the window, and how late the load generator ran. A count is sustained when no frame is lost and the
backlog does not grow. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lat_half(rec: dict, half: int) -> list[float]:
    """Latencies (ms) of the frames due in the first or second half of the
    window: a backlog that grows shows as a later half that waits
    longer."""
    n = len(rec["due"])
    ks = range(0, n // 2) if half == 0 else range(n // 2, n)
    return [(c["arrivals"][k] - rec["due"][k]) * 1e3
            for c in rec["cameras"] for k in ks if k < len(c["arrivals"])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cameras", required=True)
    args = ap.parse_args(argv)
    from vcabench import run
    run.set_cache_dirs()
    import torch

    from vcabench.drivers import live
    bench = run.load_json(ROOT, "BENCHMARK.json")
    _, cfg, mix = run.cell_spec(bench, args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for n in (int(c) for c in args.cameras.split(",")):
        s = live.serve(cfg, dict(mix, cameras=n), args.seed, args.seconds,
                       False, device)
        lat, last, back = live.latencies(s["record"])
        rec = s["record"]
        late = [max(0.0, x - d) for c in rec["cameras"]
                for x, d in zip(c["sends"], rec["due"])]
        print(json.dumps({
            "cameras": n, "frames_per_s": back / (last - rec["t0"]),
            "latency_ms_p50": statistics.median(lat),
            "latency_ms_p95": live.percentile(lat, 95),
            "latency_ms_max": max(lat),
            "dropped": sum(st["dropped"] for st in s["stats2"]),
            "out_dropped": sum(st["outDropped"] for st in s["stats2"]),
            "never_back": len(rec["due"]) * n - back,
            "backlog_growth": (sum(st["pending"] for st in s["stats1"])
                               - sum(st["pending"] for st in s["stats0"])),
            "latency_ms_p50_first_half": statistics.median(
                lat_half(rec, 0)),
            "latency_ms_p50_second_half": statistics.median(
                lat_half(rec, 1)),
            "generator_late_ms_max": 1e3 * max(late),
            "generator_late_ms_mean": 1e3 * statistics.fmean(late)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
