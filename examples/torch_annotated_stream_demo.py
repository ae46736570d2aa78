"""Annotated-stream demo on the PyTorch port — the counterpart of
``examples/annotated_stream_demo.py``.

A pipeline with a face detector opens its media port with output=1,
frames stream in over TCP, and the SAME connection returns the annotated
GRAY8 frames — optionally piped straight into ffplay. The frames are
``utils/synth`` cartoon faces (no cv2 needed).

    python examples/torch_annotated_stream_demo.py            # summary only
    python examples/torch_annotated_stream_demo.py --ffplay   # watch it live
    python examples/torch_annotated_stream_demo.py --device cpu --frames 4
"""

import argparse
import os
import socket
import subprocess
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from nubomedia_vca_tpu_torch.api.objects import (  # noqa: E402
    MediaPipeline, NuboFaceDetector)
from nubomedia_vca_tpu_torch.utils.synth import face_clip  # noqa: E402

W, H = 640, 480


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--ffplay", action="store_true",
                    help="pipe the annotated frames into ffplay")
    args = ap.parse_args(argv)
    n = args.frames

    pipe = MediaPipeline((W, H), device=args.device)
    NuboFaceDetector(pipe)
    port = pipe.listen(0, output=1)
    print(f"media port (full-duplex): {port}")

    clip = face_clip(n, W, H, seed=7)
    sink = None
    if args.ffplay:
        sink = subprocess.Popen(
            ["ffplay", "-loglevel", "error", "-f", "rawvideo",
             "-pixel_format", "gray", "-video_size", f"{W}x{H}",
             "-framerate", "8", "-i", "pipe:0"],
            stdin=subprocess.PIPE)

    try:
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.settimeout(600)

            def feeder():
                for fr in clip:
                    s.sendall(fr.tobytes())

            threading.Thread(target=feeder, daemon=True).start()
            changed = 0
            for i in range(n):
                buf = b""
                while len(buf) < W * H:
                    chunk = s.recv(W * H - len(buf))
                    if not chunk:
                        raise RuntimeError("connection closed early")
                    buf += chunk
                out = np.frombuffer(buf, np.uint8).reshape(H, W)
                changed += bool((out != clip[i]).any())
                if sink is not None:
                    sink.stdin.write(buf)
                    sink.stdin.flush()
            print(f"{n} annotated frames returned; "
                  f"{changed} carried drawn detections")
    finally:
        pipe.stopMedia()
        if sink is not None:
            sink.stdin.close()
            sink.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
