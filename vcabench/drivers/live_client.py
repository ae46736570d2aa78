"""The live traffic's load generator: a process of its own, apart from the
system under test, and never on the card.

    python3 -m vcabench.drivers.live_client '<json spec>'

It draws each camera's BGR clip from the seed on the CPU
(``frozen/scenes.py``), opens one TCP connection per camera to the ports
in the spec and writes ``ready``. It then warms each connection up with
bursts of frames (read back before the next burst), writes ``warm``, and
waits for ``go`` on its standard input. On ``go`` it writes ``start <t0>``
(``time.monotonic()``, the first frame's due time) and sends 1280x720 BGR
frames on a fixed schedule per camera (frame k due at t0 + k/fps; an open
loop: a late send does not move later ones), while one thread a camera
reads the annotated frames back and stamps their arrival. After the last
due time it waits at most ``wait_s`` for the frames still out, and writes
one JSON line: per camera the due, send and arrival times of the window's
frames and the digest of every frame read back, warm-up included.
"""

from __future__ import annotations

import hashlib
import json
import os
import select
import socket
import sys
import threading
import time

import numpy as np


def clip_index(k: int, n: int) -> int:
    """Frame k of a camera's sequence → its clip frame: the clip plays
    forward, then backward, and again."""
    k %= 2 * n
    return k if k < n else 2 * n - 1 - k


def bgr_clips(mix: dict, frame, seed: int):
    """[cameras, clip_frames, H, W, 3] uint8 BGR, on the CPU."""
    import torch

    from vcabench.frozen import scenes
    lay_mix = dict(mix, streams=mix["cameras"])
    gray, _ = scenes.clips(lay_mix, tuple(frame), seed, torch.device("cpu"))
    return scenes.to_bgr(gray, mix["tint"]).numpy()


class Camera:
    def __init__(self, port: int, clip: np.ndarray):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.clip = clip
        self.sent = 0
        self.digests: list[str] = []
        self.arrivals: list[float] = []
        self.buf = bytearray(clip[0].nbytes)
        self.got = 0

    def send_next(self) -> None:
        f = self.clip[clip_index(self.sent, len(self.clip))]
        self.sock.sendall(memoryview(f).cast("B"))
        self.sent += 1

    def read_one(self, timeout: float | None = None) -> bool | None:
        """Read on until a whole frame is in → True; None when `timeout`
        passes first (what was read is kept); False when the server
        closed the connection."""
        view = memoryview(self.buf)
        while self.got < len(view):
            if timeout is not None and not select.select(
                    [self.sock], [], [], timeout)[0]:
                return None
            n = self.sock.recv_into(view[self.got:])
            if n == 0:
                return False
            self.got += n
        t = time.monotonic()
        self.got = 0
        self.arrivals.append(t)
        self.digests.append(
            hashlib.blake2b(self.buf, digest_size=16).hexdigest())
        return True


def main(spec: dict) -> int:
    mix = spec["mix"]
    clips = bgr_clips(mix, spec["frame"], spec["seed"])
    cams = [Camera(p, clips[i]) for i, p in enumerate(spec["ports"])]
    print("ready", flush=True)
    for cam in cams:
        for burst in mix["warm_bursts"]:
            for _ in range(burst):
                cam.send_next()
            for _ in range(burst):
                if not cam.read_one():
                    raise SystemExit("live_client: connection closed in "
                                     "warm-up")
    warm = [c.sent for c in cams]
    print("warm", flush=True)
    if sys.stdin.readline().strip() != "go":
        raise SystemExit("live_client: no go")
    fps, n = mix["fps"], int(round(spec["seconds"] * mix["fps"]))
    t0 = time.monotonic() + 0.1
    print(f"start {t0!r}", flush=True)
    due = [t0 + k / fps for k in range(n)]
    sends = [[0.0] * n for _ in cams]

    def sender(ci):
        cam = cams[ci]
        for k in range(n):
            d = due[k] - time.monotonic()
            if d > 0:
                time.sleep(d)
            sends[ci][k] = time.monotonic()
            cam.send_next()

    deadline = due[-1] + mix["wait_s"]

    def reader(ci):
        cam = cams[ci]
        while len(cam.digests) < warm[ci] + n and \
                time.monotonic() < deadline:
            if cam.read_one(timeout=0.25) is False:
                return

    threads = ([threading.Thread(target=sender, args=(i,))
                for i in range(len(cams))]
               + [threading.Thread(target=reader, args=(i,))
                  for i in range(len(cams))])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cam in cams:
        cam.sock.close()
    out = {"t0": t0, "due": due, "cameras": [
        {"warm": warm[i], "sends": sends[i],
         "arrivals": cam.arrivals[warm[i]:], "digests": cam.digests}
        for i, cam in enumerate(cams)]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(json.loads(sys.argv[1])))
