"""Command-line filter runner — the analog of the reference's per-module
``run_plugin.sh`` smoke pipelines (``gst-launch-1.5 v4l2src ! videoconvert !
nubofacedetector ! autovideosink``, e.g.
nubo_face/.../gst-plugins/run_plugin.sh:3): point a filter at a video
source, watch detections stream out, optionally write annotated video.

    python -m nubomedia_vca_tpu_torch face --input clip.mp4 --output o.mp4
    python -m nubomedia_vca_tpu_torch tracker --synthetic --frames 32
    python -m nubomedia_vca_tpu_torch chain --input clip.mp4   # face→eye→mouth
    python -m nubomedia_vca_tpu_torch cnn --synthetic --device cpu
    python -m nubomedia_vca_tpu_torch warmup --size 1280x720

Sources: any cv2.VideoCapture URI (file, v4l2 index, rtsp/http) or
--synthetic procedural clips. Output: annotated video via cv2.VideoWriter
(rect overlays, the reference's view-faces mode) and one detection line per
frame on stdout.

The PyTorch port of ``nubomedia_vca_tpu/cli.py``. It runs on the card
(``--device cuda``, the default; a host without CUDA exits with an error)
unless ``--device`` names another. ``--synthetic`` clips are the port's
cv2-free ``utils/synth`` frames: moving blobs for the tracker, profile
heads for the ear, cartoon faces otherwise. ``warmup`` builds the CUDA
kernels and the native ingest and runs one ``process`` per filter and
batch size: the port's cold-start cost. Video input and ``--output`` need
cv2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .cascade.engine import _resolve_device


def _read_frames(ns):
    if ns.synthetic:
        from .utils import synth
        if ns.filter == "tracker":
            # moving blob clip for motion tracking
            return synth.blob_clip(ns.frames, 320, 240, seed=ns.seed), None
        if ns.filter == "ear":
            return np.stack([synth.profile_scene(640, 480, seed=ns.seed + t)
                             for t in range(ns.frames)]), None
        return synth.face_clip(ns.frames, 640, 480, seed=ns.seed), None

    import cv2
    src = int(ns.input) if ns.input.isdigit() else ns.input
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video source: {ns.input}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while len(frames) < ns.frames:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    cap.release()
    if not frames:
        raise SystemExit("no frames decoded")
    return np.stack(frames), fps


def _make_model(ns, frame_size):
    dev = ns.device
    if ns.filter == "face":
        from .models.face import FaceDetector
        return FaceDetector(frame_size, device=dev)
    if ns.filter == "cnn":
        from .models.cnn import CnnFaceDetector
        return CnnFaceDetector(frame_size, device=dev)
    if ns.filter == "eye":
        from .models.eye import EyeDetector
        return EyeDetector(frame_size, device=dev)
    if ns.filter == "mouth":
        from .models.mouth import MouthDetector
        return MouthDetector(frame_size, device=dev)
    if ns.filter == "nose":
        from .models.nose import NoseDetector
        return NoseDetector(frame_size, device=dev)
    if ns.filter == "ear":
        from .models.ear import EarDetector
        return EarDetector(frame_size, device=dev)
    if ns.filter == "tracker":
        from .models.tracker import Tracker
        return Tracker(frame_size, device=dev)
    if ns.filter == "parts":
        from .models.cnn_parts import CnnPartDetector
        return CnnPartDetector(frame_size, device=dev)
    raise SystemExit(f"unknown filter {ns.filter}")


def _rects_for_frame(ns, result):
    """Normalize each model family's per-frame result to [(x,y,w,h), ...]."""
    if ns.filter in ("face", "cnn"):
        return [(f.x, f.y, f.w, f.h) for f in result]
    if ns.filter == "tracker":
        return [tuple(int(v) for v in r) for r in result]
    # part detectors: dict type-name -> list of rects
    out = []
    for rects in result.values():
        out.extend(tuple(int(v) for v in r[:4]) for r in rects)
    return out


def _build_native(dev: torch.device) -> None:
    """Build the CUDA kernels (on a CUDA device; one nvcc per source, all
    started together) and the native ingest, unless already built."""
    import concurrent.futures

    from .cpp import ingest_binding
    from .ops.cuda import _build

    jobs = [ingest_binding.build_library]
    if dev.type == "cuda":
        jobs += [lambda n=p.stem: _build.build_library(n)
                 for p in sorted(_build.SRC_DIR.glob("*.cu"))]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        for fut in [ex.submit(job) for job in jobs]:
            fut.result()


def _warmup(ns) -> int:
    """Pay the port's cold-start cost once per machine: build the CUDA
    kernels and the native ingest into the build directory (later
    processes load them), then run each filter once per batch size, which
    loads the libraries and the cascades and allocates the device
    buffers."""
    import time

    W, H = (int(v) for v in ns.size.lower().split("x"))
    batches = [int(b) for b in ns.batches.split(",") if b]
    names = [f for f in ns.warm_filters.split(",") if f]
    t_all = time.time()
    _build_native(ns.device)
    print(f"warmup build: {time.time() - t_all:.0f}s", flush=True)
    for name in names:
        t0 = time.time()
        model = _make_model(argparse.Namespace(filter=name,
                                               device=ns.device), (W, H))
        for b in batches:
            model.process(np.zeros((b, H, W), np.uint8))
        if ns.device.type == "cuda":
            torch.cuda.synchronize(ns.device)
        print(f"warmup {name}: batches {batches}, "
              f"{time.time() - t0:.0f}s", flush=True)
    print(f"warmup done in {time.time() - t_all:.0f}s", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="nubomedia_vca_tpu_torch",
        description=__doc__.splitlines()[0])
    ap.add_argument("filter", choices=(
        "face", "eye", "mouth", "nose", "ear", "tracker", "cnn", "parts",
        "chain", "warmup"))
    ap.add_argument("--input", default=None,
                    help="video URI / file / v4l2 index for cv2.VideoCapture")
    ap.add_argument("--synthetic", action="store_true",
                    help="procedural test clip instead of a video source")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--output", default=None,
                    help="write annotated video here (cv2.VideoWriter)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--size", default="640x480",
                    help="warmup: frame size WxH")
    ap.add_argument("--batches", default="1,8",
                    help="warmup: comma-separated batch sizes")
    ap.add_argument("--warm-filters", default="face,eye,mouth,tracker",
                    help="warmup: comma-separated filter set")
    ns = ap.parse_args(argv)
    if ns.filter != "warmup" and not ns.synthetic and ns.input is None:
        ap.error("--input or --synthetic required")

    try:
        ns.device = _resolve_device(ns.device)
    except RuntimeError as e:
        raise SystemExit(f"nubomedia_vca_tpu_torch: {e}") from None

    if ns.filter == "warmup":
        return _warmup(ns)

    gray, src_fps = _read_frames(ns)
    n, H, W = gray.shape
    print(f"{ns.filter}: {n} frames {W}x{H}", flush=True)

    if ns.filter == "chain":
        from .models.face import FaceDetector
        from .models.eye import EyeDetector, EyeDetectorConfig
        from .models.mouth import MouthDetector
        from .pipeline.graph import FilterNode, VcaPipeline
        pipe = (VcaPipeline()
                .add(FilterNode("face", FaceDetector((W, H), device=ns.device),
                                "face", emits=("face",)))
                .add(FilterNode("eye", EyeDetector((W, H), EyeDetectorConfig(
                    detect_event=1), device=ns.device), "eye",
                    consumes={"face"}))
                .add(FilterNode("mouth", MouthDetector((W, H),
                                                       device=ns.device),
                                "mouth", consumes={"face"})))
        events = pipe.process(gray)
        rects_per_frame = []
        for i in range(n):
            dets = [d for name in ("face", "eye", "mouth")
                    for d in events[name][i].detections]
            print(f"frame {i}: " + "".join(
                f"{d.type}({d.x},{d.y},{d.width},{d.height}) " for d in dets),
                flush=True)
            rects_per_frame.append(
                [(d.x, d.y, d.width, d.height) for d in dets])
    else:
        model = _make_model(ns, (W, H))
        per_frame = model.process(gray)
        rects_per_frame = []
        for i, res in enumerate(per_frame):
            rects = _rects_for_frame(ns, res)
            print(f"frame {i}: " + "".join(f"({x},{y},{w},{h}) "
                                           for x, y, w, h in rects),
                  flush=True)
            rects_per_frame.append(rects)

    if ns.output:
        import cv2
        from .api.render import render_detections
        rendered = render_detections(gray, rects_per_frame,
                                     device=ns.device).cpu().numpy()
        vw = cv2.VideoWriter(ns.output, cv2.VideoWriter_fourcc(*"mp4v"),
                             src_fps or 25.0, (W, H))
        for fr in rendered:
            vw.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
        vw.release()
        print(f"wrote {ns.output}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
