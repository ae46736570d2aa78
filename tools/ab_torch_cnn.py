"""The learned detectors' serving forward in two trees of the port, in
turns on one CUDA GPU.

    python3 tools/ab_torch_cnn.py --old DIR    # DIR: another checkout

DIR holds another commit of the repo (for example the parent, unpacked
with ``git archive``). Each side runs in a process of its own, in the
order old, new, new, old, and imports the port from its own tree. On a
B=64 batch of 720p ``utils/synth.face_clip`` frames each side reports,
for ``CnnFaceDetector`` and ``CnnPartDetector`` with their bundled
checkpoints: the forward's device ms (CUDA events, warm), the device
path's (letterbox, forward, decode, NMS) and the device kernels of one
forward (``torch.profiler``). Every line carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, FRAME, REPS = 64, (1280, 720), 50


def device_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def forward_kernels(fn) -> int:
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def child(root: str) -> None:
    """One side: the port imported from `root` → one JSON line."""
    sys.path.insert(0, root)
    import torch
    from nubomedia_vca_tpu_torch.models.cnn import CnnFaceDetector
    from nubomedia_vca_tpu_torch.models.cnn_parts import CnnPartDetector
    from nubomedia_vca_tpu_torch.utils.synth import face_clip

    dev = torch.device("cuda", 0)
    gray = torch.from_numpy(face_clip(B, *FRAME, seed=11)).to(dev)
    out = {}
    for cls in (CnnFaceDetector, CnnPartDetector):
        det = cls(FRAME, device=dev)
        canvas = det.letterbox(gray)
        with torch.no_grad():
            out[cls.__name__] = {
                "forward_ms": device_ms(lambda: det.model(canvas)),
                "device_path_ms": device_ms(lambda: det.detect_device(gray)),
                "forward_kernels": forward_kernels(lambda: det.model(canvas)),
            }
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="another checkout of the repo")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    if not args.old:
        ap.error("--old DIR is needed")
    new = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for side, root in (("old", args.old), ("new", new), ("new", new),
                       ("old", args.old)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(root)], capture_output=True, text=True,
            check=True, timeout=600)
        for name, r in json.loads(res.stdout.strip().splitlines()[-1]).items():
            print(f"ab: {side} {name} forward {r['forward_ms']:.4f} ms, "
                  f"device path {r['device_path_ms']:.4f} ms, "
                  f"{r['forward_kernels']} device kernels per forward; "
                  f"B={B} {FRAME[0]}x{FRAME[1]} [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
