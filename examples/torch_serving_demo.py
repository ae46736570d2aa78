"""Multi-stream serving demo on the PyTorch port — the counterpart of
``examples/serving_demo.py``: N simulated camera streams push frames into
the native ingest feeder; the batching scheduler assembles static-size
batches, runs the face detector on the device, and routes detections back
per stream.

    python examples/torch_serving_demo.py [--device cpu] [--streams 6]
                                          [--frames 12]

The frames are ``utils/synth`` cartoon faces (no cv2 needed).
"""

import argparse
import os
import sys
import threading
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--streams", type=int, default=6)
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args(argv)

    from nubomedia_vca_tpu_torch.models.face import FaceDetector
    from nubomedia_vca_tpu_torch.pipeline.scheduler import StreamFeeder
    from nubomedia_vca_tpu_torch.utils.synth import face_scene
    from nubomedia_vca_tpu_torch.utils.tracing import TRACER

    TRACER.enabled = True      # the report below reads the run's spans
    W, H = 640, 480
    feeder = StreamFeeder(W, H, batch=8)
    fd = FaceDetector((W, H), device=args.device)

    # producers: each stream pushes frames with its face at a distinct spot
    def producer(sid):
        for t in range(args.frames):
            frame = face_scene(
                W, H, faces=((260 + 30 * (sid % 5), 230 + 2 * t, 150),),
                noise=5, seed=sid * 100 + t)
            feeder.push(sid, frame, pts=t)
            time.sleep(0.002)

    threads = [threading.Thread(target=producer, args=(s,))
               for s in range(args.streams)]
    for t in threads:
        t.start()

    results = defaultdict(list)
    total = args.streams * args.frames
    t0 = time.perf_counter()
    seen = 0
    try:
        while seen < total:
            nb = feeder.next_batch()
            if nb is None:
                time.sleep(0.002)
                continue
            frames, pts, streams, n = nb
            dets = fd.detect_boxes(frames)
            for i in range(n):
                results[int(streams[i])].append(
                    (int(pts[i]), dets[i].tolist()))
                seen += 1
    finally:
        for t in threads:
            t.join()
        feeder.ingest.close()
    dt = time.perf_counter() - t0

    nframes = sum(len(v) for v in results.values())
    print(f"processed {nframes} frames from {len(results)} streams "
          f"in {dt:.2f}s ({nframes / dt:.0f} fps aggregate)")
    for sid in sorted(results)[:4]:
        pts, dets = results[sid][-1]
        print(f"  stream {sid}: last frame pts={pts} faces={dets}")
    print(TRACER.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
