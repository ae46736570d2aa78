"""Readings that set the limits of the check, on the chip, at a cell's own
size and load.

    python3 vcabench/control.py --workload face720p.archive \
        --seeds 11,12,13 --seconds 10

For each seed, in one process: the program's reading (a window of the
cell, then the share of frames whose result differs from the float32
reference), and the control's reading (the reference computed in
bfloat16 put in the program's place, over the same calls or, for live
traffic, the same sample of annotated frames). For archive traffic it
also counts the frames whose reference result is not empty. One JSON
line per seed. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from vcabench import run
    run.set_cache_dirs()
    import torch

    from vcabench.drivers import archive
    bench = run.load_json(ROOT, "BENCHMARK.json")
    _, cfg, mix = run.cell_spec(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("control: needs a CUDA card")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cascade_dir = os.path.join(ROOT, run.PACKAGE, "assets", "haarcascades")
    if mix["kind"] == "live":
        return live_readings(args, cfg, mix, device, cascade_dir)
    for seed in (int(s) for s in args.seeds.split(",")):
        a = archive.Archive(cfg, mix, seed, device, cascade_dir)
        a.warm_up()
        t0 = time.perf_counter()
        i = done = 0
        while time.perf_counter() < t0 + args.seconds:
            done += a.call(i)
            i += 1
        fps = done / (time.perf_counter() - t0)
        a.release()
        want = a.expected(a.reference())
        n, bad = a.compare(want, dict(enumerate(a.results)))
        ctrl = a.expected(a.reference(torch.bfloat16))
        _, bad_c = a.compare(want, ctrl)
        found = sum(1 for res in want.values() for r in res
                    if (any(r.values()) if isinstance(r, dict) else r))
        both = sum(1 for res in want.values() for r in res
                   if isinstance(r, dict) and all(r.values()))
        print(json.dumps({
            "workload": args.workload, "seed": seed, "calls": i,
            "frames_per_s": fps, "frames": n,
            "program_differing_pct": 100.0 * bad / max(n, 1),
            "control_differing_pct": 100.0 * bad_c / max(n, 1),
            "frames_with_result_pct": 100.0 * found / max(n, 1),
            "frames_with_both_eyes_pct": 100.0 * both / max(n, 1),
            "unanswered": i * a.batch - done}), flush=True)
    return 0


def live_readings(args, cfg, mix, device, cascade_dir) -> int:
    """The live cell's readings: a served window per seed (the program),
    and the bfloat16 reference's annotated frames against the float32
    reference's on the same sample."""
    import torch

    from vcabench.drivers import live
    for seed in (int(s) for s in args.seeds.split(",")):
        s = live.serve(cfg, mix, seed, args.seconds, False, device)
        rec = s["record"]
        want = live.expected(cfg, mix, seed, rec, cascade_dir, device)
        n, bad = live.compare(want, [c["digests"] for c in rec["cameras"]])
        ctrl = live.expected(cfg, mix, seed, rec, cascade_dir, device,
                             torch.bfloat16)
        bad_c = sum(ctrl[c][k] != d for c, w in enumerate(want)
                    for k, d in w.items())
        lat, last, back = live.latencies(rec)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "frames_per_s": back / (last - rec["t0"]), "frames": n,
            "program_differing_pct": 100.0 * bad / max(n, 1),
            "control_differing_pct": 100.0 * bad_c / max(n, 1),
            "unanswered": len(rec["due"]) * mix["cameras"] - back}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
