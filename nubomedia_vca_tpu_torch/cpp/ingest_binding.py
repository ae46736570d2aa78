"""ctypes binding for the native ingest feeder (``cpp/ingest``), with a pure
NumPy fallback so everything runs without the native build.

The PyTorch port of ``nubomedia_vca_tpu/cpp/ingest_binding.py``. The port
keeps its own copy of ``vca_ingest.cpp`` (the JAX package's, plus the
queue-wait sums the media loop's tracing reads) and builds it at
first use (never at import) with ``g++ -O2 -shared -fPIC -pthread`` into the
directory the CUDA kernels build into (``ops/cuda/_build.build_dir``:
``$NUBOMEDIA_VCA_KERNEL_DIR``, else the checkout's ``build/torch_kernels/``,
else ``~/.cache/nubomedia_vca_tpu_torch/kernels/``), as
``libvca_ingest_<digest>.so`` keyed by the source and the flags; it never
writes into the source tree. Both feeders run on the host: frames leave
them as numpy arrays, and their consumers upload them to their device.

Both stamp each queued frame on the monotonic clock (``steady_clock``,
``time.monotonic_ns``) and, at collect, add the frames drained and their
waits in the queue to two running sums: ``collected`` and
``collect_wait_ns``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from collections import deque

import numpy as np
import torch

from ..ops.color import bgr_to_gray
from ..ops.cuda._build import build_dir
from ..ops.resize import resize_linear_exact
from ..utils.logging import get_logger

SRC = pathlib.Path(__file__).resolve().parent / "ingest" / "vca_ingest.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> pathlib.Path:
    """Where the built library goes, named by a digest of the source and
    the flags (an edited source is rebuilt, an unchanged one reused)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return build_dir() / f"libvca_ingest_{h.hexdigest()[:16]}.so"


def build_library() -> pathlib.Path:
    """Compile ``vca_ingest.cpp`` unless its library exists → its path.
    Raises when no C++ compiler is found or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the "
                           "native ingest")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native ingest failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _load():
    """The native library with its C signatures, or None when it cannot be
    built or loaded (the reason is logged; make_ingest then takes
    PythonIngest)."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError) as e:
        get_logger("ingest").warning("native ingest unavailable: %s", e)
        return None
    lib.vca_ingest_create.restype = ctypes.c_void_p
    lib.vca_ingest_create.argtypes = [ctypes.c_int] * 3
    lib.vca_ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.vca_ingest_push.restype = ctypes.c_int
    lib.vca_ingest_push.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64,
    ]
    lib.vca_ingest_collect.restype = ctypes.c_int
    lib.vca_ingest_collect.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.vca_ingest_pending.restype = ctypes.c_int
    lib.vca_ingest_pending.argtypes = [ctypes.c_void_p]
    lib.vca_ingest_dropped.restype = ctypes.c_int64
    lib.vca_ingest_dropped.argtypes = [ctypes.c_void_p]
    lib.vca_ingest_collected.restype = ctypes.c_int64
    lib.vca_ingest_collected.argtypes = [ctypes.c_void_p]
    lib.vca_ingest_collect_wait_ns.restype = ctypes.c_int64
    lib.vca_ingest_collect_wait_ns.argtypes = [ctypes.c_void_p]
    lib.vca_ingest_out_dropped.restype = ctypes.c_int64
    lib.vca_ingest_out_dropped.argtypes = [ctypes.c_void_p]
    lib.vca_ingest_listen.restype = ctypes.c_int
    lib.vca_ingest_listen.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    lib.vca_ingest_stop_listen.argtypes = [ctypes.c_void_p]
    lib.vca_ingest_set_work.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
    lib.vca_ingest_send.restype = ctypes.c_int
    lib.vca_ingest_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int]
    lib.vca_ingest_set_retain_color.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
    lib.vca_ingest_collect_color.restype = ctypes.c_int
    lib.vca_ingest_collect_color.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


class NativeIngest:
    """Multi-stream frame assembler (native when available)."""

    def __init__(self, width: int, height: int, capacity: int = 256):
        self.w, self.h = width, height
        self.out_w, self.out_h = width, height   # collect() frame shape
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._h = self._lib.vca_ingest_create(width, height, capacity)

    def set_work(self, work_w: int = 0, work_h: int = 0) -> None:
        """Enable bit-exact INTER_LINEAR_EXACT downscale at push time:
        collect() then yields [B, work_h, work_w] — only working-resolution
        luma crosses host→device (the reference also downscales on the CPU
        before detecting, kmsfacedetect.cpp:805). Pass 0,0 to disable."""
        self._lib.vca_ingest_set_work(self._h, work_w, work_h)
        if work_w and work_h and (work_w, work_h) != (self.w, self.h):
            self.out_w, self.out_h = work_w, work_h
        else:
            self.out_w, self.out_h = self.w, self.h

    def send(self, stream: int, data) -> bool:
        """Queue annotated frame bytes for write-back on the stream's TCP
        connection (media-plane output). False when the stream has no live
        connection (in-process pushes)."""
        buf = np.ascontiguousarray(data, np.uint8)
        rc = self._lib.vca_ingest_send(self._h, stream, buf.ctypes.data,
                                       buf.size)
        return rc == 0

    def push(self, stream: int, frame: np.ndarray, pts: int = 0) -> None:
        frame = np.ascontiguousarray(frame, np.uint8)
        channels = 1 if frame.ndim == 2 else frame.shape[2]
        stride = frame.strides[0]
        rc = self._lib.vca_ingest_push(
            self._h, stream, frame.ctypes.data, stride, channels, pts)
        if rc != 0:
            raise ValueError(f"bad frame format (channels={channels})")

    def collect(self, max_frames: int, min_frames: int = 1,
                wait_ms: int = 0):
        out = np.empty((max_frames, self.out_h, self.out_w), np.uint8)
        pts = np.empty(max_frames, np.int64)
        streams = np.empty(max_frames, np.int32)
        n = self._lib.vca_ingest_collect(
            self._h, out.ctypes.data, pts.ctypes.data, streams.ctypes.data,
            max_frames, min_frames, wait_ms)
        return out[:n], pts[:n], streams[:n]

    def set_retain_color(self, on: bool) -> None:
        """Retain a tight FULL-RESOLUTION BGR copy of each color push so
        the media loop can draw on the COLOR frame (the reference annotates
        the color frame in place, kmsfacedetect.cpp:857-898). Composes with
        set_work downscale: detection then runs on work-res luma while the
        retained full-res frame is the host-side annotation canvas
        (detect-downscaled + draw-full-res, kmsfacedetect.cpp:805,832-850)."""
        self._lib.vca_ingest_set_retain_color(self._h, int(bool(on)))

    def collect_color(self, max_frames: int, min_frames: int = 1,
                      wait_ms: int = 0):
        """collect() + the retained BGR frames [B,H,W,3] (zero-filled for
        gray/I420 pushes or pushes made before retention was enabled).
        The gray plane follows the work resolution when set_work is active;
        the color plane is always full resolution."""
        out = np.empty((max_frames, self.out_h, self.out_w), np.uint8)
        color = np.empty((max_frames, self.h, self.w, 3), np.uint8)
        pts = np.empty(max_frames, np.int64)
        streams = np.empty(max_frames, np.int32)
        n = self._lib.vca_ingest_collect_color(
            self._h, out.ctypes.data, color.ctypes.data, pts.ctypes.data,
            streams.ctypes.data, max_frames, min_frames, wait_ms)
        return out[:n], color[:n], pts[:n], streams[:n]

    def pending(self) -> int:
        return self._lib.vca_ingest_pending(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.vca_ingest_dropped(self._h)

    @property
    def collected(self) -> int:
        """Frames collected so far."""
        return self._lib.vca_ingest_collected(self._h)

    @property
    def collect_wait_ns(self) -> int:
        """Summed wait of the collected frames in the queue (ns)."""
        return self._lib.vca_ingest_collect_wait_ns(self._h)

    @property
    def out_dropped(self) -> int:
        """Annotated frames dropped by slow readers (live connections)."""
        return self._lib.vca_ingest_out_dropped(self._h)

    def listen(self, port: int = 0, channels: int = 1) -> int:
        """Open a loopback TCP port accepting raw-video byte streams (one
        connection per stream; W*H*channels bytes per frame, or
        channels=-1 for I420/NV12 at W*H*3/2 bytes with the leading luma
        consumed) — the live bridge for gst-launch tcpclientsink / ffmpeg
        rawvideo tcp://. Returns the bound port."""
        p = self._lib.vca_ingest_listen(self._h, port, channels)
        if p < 0:
            raise OSError("vca_ingest_listen failed (already listening?)")
        return p

    def stop_listen(self) -> None:
        self._lib.vca_ingest_stop_listen(self._h)

    def close(self):
        if self._h:
            self._lib.vca_ingest_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PythonIngest:
    """Pure-python fallback with identical semantics."""

    def __init__(self, width: int, height: int, capacity: int = 256):
        self.w, self.h = width, height
        self.out_w, self.out_h = width, height
        self.capacity = capacity
        self._q = deque()
        self._mu = threading.Lock()
        self._conns: dict[int, "object"] = {}
        self._out_queues: dict[int, deque] = {}
        self.dropped = 0
        self.out_dropped = 0
        self.collected = 0
        self.collect_wait_ns = 0
        self._retain_color = False

    def set_work(self, work_w: int = 0, work_h: int = 0) -> None:
        """Downscale-at-push (same semantics as NativeIngest.set_work);
        uses ops/resize.resize_linear_exact on the host so it is bit-exact
        with the device path by construction."""
        if work_w and work_h and (work_w, work_h) != (self.w, self.h):
            self.out_w, self.out_h = work_w, work_h
        else:
            self.out_w, self.out_h = self.w, self.h
        with self._mu:
            self._q.clear()   # queued frames have the old shape

    MAX_OUT_QUEUE = 64   # drop-oldest bound, mirrors the native Conn queue

    def send(self, stream: int, data) -> bool:
        """Queue annotated frame bytes for write-back on the stream's TCP
        connection (media-plane output); False without a live connection.
        A per-connection writer thread drains a BOUNDED queue so a slow or
        absent reader can neither block the media loop nor grow memory."""
        conn = self._conns.get(stream)
        if conn is None:
            return False
        q = self._out_queues.get(stream)
        if q is None:
            q = self._out_queues[stream] = deque()

            def writer():
                try:
                    while stream in self._conns:
                        try:
                            buf = q.popleft()
                        except IndexError:
                            time.sleep(0.005)
                            continue
                        try:
                            self._conns[stream].sendall(buf)
                        except (OSError, KeyError):
                            self._conns.pop(stream, None)
                            return
                finally:
                    # every exit path must release the queue — stream ids
                    # are never reused, so a leak here pins up to
                    # MAX_OUT_QUEUE full frames per dead connection
                    self._out_queues.pop(stream, None)

            threading.Thread(target=writer, daemon=True).start()
        if len(q) >= self.MAX_OUT_QUEUE:
            q.popleft()
            self.out_dropped += 1
        q.append(np.ascontiguousarray(data, np.uint8).tobytes())
        return True

    def set_retain_color(self, on: bool) -> None:
        """Same semantics as NativeIngest.set_retain_color."""
        self._retain_color = bool(on)
        with self._mu:
            self._q.clear()

    def push(self, stream: int, frame: np.ndarray, pts: int = 0) -> None:
        frame = np.asarray(frame)
        color = None
        if frame.ndim == 3:
            if self._retain_color:
                # full-res BGR canvas, kept even when downscaling the luma
                color = np.ascontiguousarray(frame[..., :3], np.uint8)
            frame = bgr_to_gray(torch.from_numpy(
                np.ascontiguousarray(frame[..., :3], np.uint8))).numpy()
        if (self.out_w, self.out_h) != (self.w, self.h):
            frame = resize_linear_exact(
                torch.from_numpy(np.ascontiguousarray(frame, np.uint8)),
                (self.out_w, self.out_h)).numpy()
        with self._mu:
            if len(self._q) >= self.capacity:
                self._q.popleft()
                self.dropped += 1
            self._q.append((frame.astype(np.uint8), color, pts, stream,
                            time.monotonic_ns()))

    def _drain(self, max_frames: int):
        frames, colors, pts, streams = [], [], [], []
        with self._mu:
            now = time.monotonic_ns()
            while self._q and len(frames) < max_frames:
                f, c, p, s, pushed = self._q.popleft()
                frames.append(f)
                colors.append(c)
                pts.append(p)
                streams.append(s)
                self.collect_wait_ns += now - pushed
            self.collected += len(frames)
        return frames, colors, pts, streams

    def collect(self, max_frames: int, min_frames: int = 1, wait_ms: int = 0):
        frames, _, pts, streams = self._drain(max_frames)
        if not frames:
            return (np.empty((0, self.out_h, self.out_w), np.uint8),
                    np.empty(0, np.int64), np.empty(0, np.int32))
        return (np.stack(frames), np.asarray(pts, np.int64),
                np.asarray(streams, np.int32))

    def collect_color(self, max_frames: int, min_frames: int = 1,
                      wait_ms: int = 0):
        """collect() + retained full-res BGR frames (zeros when not
        retained); gray plane follows the work resolution when set."""
        frames, colors, pts, streams = self._drain(max_frames)
        if not frames:
            return (np.empty((0, self.out_h, self.out_w), np.uint8),
                    np.empty((0, self.h, self.w, 3), np.uint8),
                    np.empty(0, np.int64), np.empty(0, np.int32))
        color = np.stack([
            c if c is not None else np.zeros((self.h, self.w, 3), np.uint8)
            for c in colors
        ])
        return (np.stack(frames), color, np.asarray(pts, np.int64),
                np.asarray(streams, np.int32))

    def pending(self) -> int:
        return len(self._q)

    def listen(self, port: int = 0, channels: int = 1) -> int:
        """Python fallback of NativeIngest.listen (same wire format;
        channels=-1 = I420/NV12: W*H*3/2 bytes per frame, leading luma
        consumed, chroma tail framed and discarded)."""
        import socket

        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(16)
        self._listen_sock = srv
        self._listen_stop = threading.Event()
        luma = self.w * self.h
        frame_bytes = luma * 3 // 2 if channels == -1 else luma * channels

        def reader(conn, stream):
            pts = 0
            self._conns[stream] = conn
            try:
                with conn:
                    while not self._listen_stop.is_set():
                        buf = b""
                        while len(buf) < frame_bytes:
                            chunk = conn.recv(frame_bytes - len(buf))
                            if not chunk:
                                return
                            buf += chunk
                        frame = np.frombuffer(buf, np.uint8)
                        if channels in (1, -1):
                            frame = frame[:luma].reshape(self.h, self.w)
                        else:
                            frame = frame.reshape(self.h, self.w, channels)
                        self.push(stream, frame, pts)
                        pts += 1
            finally:
                self._conns.pop(stream, None)

        def acceptor():
            stream = 0
            while not self._listen_stop.is_set():
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return
                threading.Thread(target=reader, args=(conn, stream),
                                 daemon=True).start()
                stream += 1

        threading.Thread(target=acceptor, daemon=True).start()
        return srv.getsockname()[1]

    def stop_listen(self) -> None:
        if getattr(self, "_listen_stop", None) is not None:
            self._listen_stop.set()
            self._listen_sock.close()

    def close(self):
        self.stop_listen()


def make_ingest(width: int, height: int, capacity: int = 256):
    """Native feeder when the .so builds; python fallback otherwise."""
    if _load() is not None:
        return NativeIngest(width, height, capacity)
    return PythonIngest(width, height, capacity)
