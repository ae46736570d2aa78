"""Media loop — the missing middle of the Kurento deployment shape.

In the reference, media flows through the GStreamer pipeline (WebRTC/RTP
decoded by Kurento) and the app only talks JSON-RPC; the filter elements
see frames because they sit in the media graph. Here the equivalent wiring
is: a `MediaRunner` owns a frame ingest (with the raw-video TCP listener —
feed it from ``gst-launch … ! tcpclientsink`` or ``ffmpeg -f rawvideo
tcp://…``) and drives the pipeline's created elements in registration
order, chaining detections exactly like the GstEvent flow (SURVEY.md
§2.4.8): tracker motion events refuel face-detector gates
(kmsfacedetect.cpp:698-707), face boxes feed event-gated part detectors
(kmseyedetect.cpp:680-724), and each element emits its rate-limited server
events to RPC subscribers.

Media-plane output (the reference's primary product — the annotated frame
continues downstream in place, kmsfacedetect.cpp:857-898, into
autovideosink via run_plugin.sh:3): with ``output`` enabled, every element
with its view knob on draws its detections on-device
(`_FilterObject.render` — rectangles/circles/costume overlay honoring
showFaces/visual_mode/setOverlayedImage) and the annotated frames are
written back on each stream's own TCP connection, so
``gst-launch … tcpclientsink`` → detect → read-back → ``autovideosink``
reproduces the run_plugin.sh experience live. Keep the connection open
while reading back; output frames come in input order — W*H*3 BGR when
``listen(channels=3, output=1)`` (the ingest retains the color frame and
detections are drawn on it, matching the reference's in-place color
annotation), W*H GRAY8 for gray listeners.

Apps never import this module: `MediaPipeline.listen()` (an RPC-invokable
method) lazily starts the runner and returns the bound TCP port.

The PyTorch port of ``nubomedia_vca_tpu/api/media_loop.py``: the same
chaining, downscale rules and counters. The loop thread selects the
pipeline's CUDA device before its first step, so every kernel it launches
goes to that card, on the thread's current stream; a device-mode render
keeps the batch on the device and makes one host copy at the end.
"""

from __future__ import annotations

import atexit
import threading
import weakref

import numpy as np
import torch

from ..ops.color import bgr_to_gray
from ..utils.tracing import active, count, trace

_RUNNERS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _stop_all_runners() -> None:
    """Join every live runner thread before interpreter teardown.

    A daemon thread abandoned inside a native call (a kernel build, a CUDA
    launch) gets pthread_exit'd at interpreter finalization; the forced
    unwind through C++ frames can abort the whole process. Joining here
    (however long the in-flight step takes) is strictly better than a
    crash."""
    for r in list(_RUNNERS):
        try:
            r.stop()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass


class MediaRunner:
    """Background frame loop binding one ingest to one MediaPipeline."""

    def __init__(self, pipeline, batch: int = 8, capacity: int = 64):
        from ..cpp.ingest_binding import make_ingest

        self.pipeline = pipeline
        self.batch = batch
        w, h = pipeline.frame_size
        self.ingest = make_ingest(w, h, capacity=capacity)
        self._stop = threading.Event()
        self._thread = None
        self.port = None
        self.output = False
        self.color_output = False
        self._downscale_res = None
        self.frames_processed = 0
        self.frames_sent = 0
        self.on_annotated = None   # callback(frames [B,H,W], stream) hook
        _RUNNERS.add(self)

    # -- lifecycle ----------------------------------------------------------
    def listen(self, port: int = 0, channels: int = 1, output: bool = False,
               downscale: bool = False) -> int:
        """Open the raw-video TCP port. output=True turns on the
        media-plane return path: annotated frames written back per
        connection — BGR in/out when channels is 3 or 4 (the ingest
        retains the color frame and detections are drawn on it, exactly
        the reference's in-place color annotation,
        kmsfacedetect.cpp:857-898), GRAY8 in/out otherwise.
        downscale=True downscales frames to the elements' common working
        resolution at ingest (full-resolution frames never cross
        host→device). Combined output+downscale (color listeners only)
        detects from the work-res luma and draws host-side on the
        retained full-res BGR frame — the reference's exact shape: detect
        on the downscaled copy, annotate img_orig
        (kmsfacedetect.cpp:805,832-850)."""
        if output and downscale and channels not in (3, 4):
            raise ValueError(
                "output+downscale needs a color listener (channels 3/4): "
                "only work-res luma is kept on the gray path, so there is "
                "no full-res frame to annotate")
        if self.port is not None:
            raise OSError("runner is already listening on port "
                          f"{self.port}")
        if downscale:
            self.enable_ingest_downscale()   # validates before any socket
        color = bool(output) and channels in (3, 4)
        if color:
            self.ingest.set_retain_color(True)
        try:
            self.port = self.ingest.listen(port, channels)
        except Exception:
            # a failed listen() must not leave the live ingest
            # half-configured (retention/downscale already applied above)
            if color:
                self.ingest.set_retain_color(False)
            if downscale:
                self.ingest.set_work(0, 0)
                self._downscale_res = None
            raise
        self.output = bool(output)
        self.color_output = color
        self._start()
        return self.port

    def enable_ingest_downscale(self) -> None:
        """Downscale to the working resolution at ingest (bit-exact
        INTER_LINEAR_EXACT, the same table-driven scheme as ops/resize.py,
        so the device resize becomes an identity and results are unchanged)
        — only valid when every element detects at ONE resolution (face /
        CNN detectors; part detectors need two, the tracker needs full
        frames)."""
        res = self._common_work_resolution()
        if res is None:
            raise ValueError(
                "ingest downscale needs every element to share one working "
                "resolution (face/CNN detectors only)")
        self.ingest.set_work(*res)
        self._downscale_res = res

    def _common_work_resolution(self):
        res = set()
        for el in self.pipeline.elements:
            model = el._ensure_model()
            if hasattr(model, "work_w"):            # FaceDetector
                res.add((model.work_w, model.work_h))
            elif hasattr(model, "WORK_W"):          # CnnFaceDetector
                if getattr(model, "multi_scale", False):
                    return None   # the 640-wide pass needs full frames
                # the letterbox resize target (aspect preserved), not the
                # padded canvas: the device pad stays, the resize becomes
                # an identity
                res.add((model._rw, model._rh))
            else:                                   # parts / tracker
                return None
        return res.pop() if len(res) == 1 else None

    def push(self, frame, pts: int = 0, stream: int = 0) -> None:
        """Direct in-process feed (tests / co-located apps)."""
        self.ingest.push(stream, frame, pts)
        self._start()

    def stats(self) -> dict:
        """Serving counters: processed/sent frames, queue depth, and the
        two backpressure drop counters (input drop-oldest; annotated
        frames dropped on slow readers)."""
        return {
            "framesProcessed": self.frames_processed,
            "framesSent": self.frames_sent,
            "pending": self.ingest.pending(),
            "dropped": int(getattr(self.ingest, "dropped", 0)),
            "outDropped": int(getattr(self.ingest, "out_dropped", 0)),
            "downscale": list(self._downscale_res or ()),
            "output": self.output,
            "colorOutput": self.color_output,
        }

    def _start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop the loop and JOIN the worker (blocking until any in-flight
        element step — possibly a first kernel build — ends;
        abandoning the thread would crash the process at interpreter exit,
        see _stop_all_runners)."""
        self._stop.set()
        try:
            self.ingest.stop_listen()
        except Exception:  # noqa: BLE001 — not listening
            pass
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- the loop -----------------------------------------------------------
    def _step(self, frames, stream: int = 0, color=None) -> None:
        """Run every element of the pipeline over one frame batch with the
        reference's chaining semantics, then (output mode) render + return
        annotated frames.

        Chain state — all keyed per stream inside the models, so any number
        of TCP connections share one element set without corrupting each
        other's temporal state:
          tracker blobs   → motion events refueling downstream face gates
                            (kmsfacedetect.cpp:698-707);
          face boxes      → part-detector ROI supply (GstEvent analog,
                            kmseyedetect.cpp:680-724)."""
        face_boxes = None
        motion_events = None
        rendered: list = []
        with trace("vca.media.elements"):
            for el in list(self.pipeline.elements):
                if self._stop.is_set():
                    return
                try:
                    if hasattr(el, "_config") and hasattr(
                            el._config, "face_cascade_path"):
                        # part detector: consumes upstream face boxes
                        res = el.process(frames, face_boxes=face_boxes,
                                         stream=stream)
                    elif el.__class__.__name__ in ("NuboFaceDetector",
                                                   "NuboCnnFaceDetector"):
                        res = el.process(frames, stream=stream,
                                         events=motion_events)
                        face_boxes = [
                            np.array([f.rect() for f in faces])
                            if faces else None
                            for faces in res
                        ]
                    elif el.__class__.__name__ == "NuboTracker":
                        res = el.process(frames, stream=stream)
                        motion_events = [blobs if blobs else None
                                         for blobs in res]
                    else:
                        res = el.process(frames)
                    rendered.append((el, res))
                except Exception:  # noqa: BLE001 — one element must not kill
                    import traceback
                    traceback.print_exc()
        self.frames_processed += len(frames)
        count("vca.media.steps")
        count("vca.media.frames", len(frames))
        if self.output or self.on_annotated is not None:
            # detect-downscaled mode: the full-res canvas exists only
            # host-side (retained BGR) — draw with the bit-identical numpy
            # twins instead of shipping 3-channel frames to the device
            host = self._downscale_res is not None and color is not None
            self._emit_annotated(color if color is not None else frames,
                                 rendered, stream, host=host)

    def _emit_annotated(self, frames, rendered, stream: int,
                        host: bool = False) -> None:
        """Draw every view-enabled element's detections in registration
        order (each reference element draws in place as the frame passes
        through it) and return the result to the stream — BGR when the
        listener retains color (the reference's product is the annotated
        COLOR stream), GRAY8 otherwise. host=True keeps the whole chain in
        numpy (detection boxes are tiny host data; the reference draws on
        the CPU too, kmsfacedetect.cpp:832-850)."""
        with trace("vca.media.emit"):
            color_mode = getattr(frames, "ndim", 3) == 4
            # device mode: the batch stays a DEVICE array across the whole
            # render chain (each el.render is a pure device op); one host
            # transfer at the end. host mode: numpy end to end.
            out = frames
            for el, res in rendered:
                try:
                    out = el.render(out, res, host=host)
                except Exception:  # noqa: BLE001
                    import traceback
                    traceback.print_exc()
            if not color_mode and getattr(out, "ndim", 3) == 4:
                # gray mode + costume overlay → BGR intermediate; back to
                # Y on the batch's device
                out = bgr_to_gray(torch.as_tensor(out))
            out = out.cpu().numpy() if isinstance(out, torch.Tensor) \
                else np.asarray(out)
            if self.on_annotated is not None:
                self.on_annotated(out, stream)
            if self.output and hasattr(self.ingest, "send"):
                for fr in out:
                    if self.ingest.send(stream, fr):
                        self.frames_sent += 1

    def _check_downscale_still_valid(self) -> None:
        """A mid-stream RPC setter (widthToProcess, setMultiScale, a new
        element) can invalidate the resolution the ingest downscale was
        locked to; detect it each loop turn and auto-heal by reverting to
        full-resolution ingest (set_work clears the stale-shape queue)
        rather than silently feeding wrong-resolution frames."""
        if self._downscale_res is None:
            return
        res = self._common_work_resolution()
        if res != self._downscale_res:
            print("media_loop: element reconfiguration invalidated the "
                  f"ingest downscale {self._downscale_res} -> full-res "
                  "ingest restored", flush=True)
            self.ingest.set_work(0, 0)
            self._downscale_res = None

    def _loop(self) -> None:
        import time

        if self.pipeline.device.type == "cuda":
            # a new thread's current device is 0: select the pipeline's
            # card before anything of this thread touches CUDA
            torch.cuda.set_device(self.pipeline.device)
        while not self._stop.is_set():
            self._check_downscale_still_valid()
            color = None
            tracing = active()
            if tracing:
                waited, collected = (self.ingest.collect_wait_ns,
                                     self.ingest.collected)
            with trace("vca.media.collect"):
                if self.color_output:
                    frames, color, pts, streams = self.ingest.collect_color(
                        self.batch, min_frames=1, wait_ms=50)
                else:
                    frames, pts, streams = self.ingest.collect(
                        self.batch, min_frames=1, wait_ms=50)
            if tracing:
                # the wait of this collect's frames in the ingest's queue
                count("vca.ingest.wait_us",
                      (self.ingest.collect_wait_ns - waited) // 1000)
                count("vca.ingest.frames", self.ingest.collected - collected)
            if frames.shape[0] == 0:
                time.sleep(0.005)
                continue
            # frames arrive interleaved across TCP connections; process
            # per-stream so temporal state never crosses streams
            for s in np.unique(streams):
                sel = streams == s
                with trace("vca.media.step", {"stream": int(s)}):
                    self._step(frames[sel], stream=int(s),
                               color=None if color is None else color[sel])
