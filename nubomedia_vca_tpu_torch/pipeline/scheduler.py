"""Multi-stream batching scheduler (SURVEY.md §2.5: "host-side stream
scheduler that assembles device batches from multiple streams").

The reference scaled out with one-filter-per-stream OS threads; here many
streams share one chip: producer threads push frames into the native ingest
feeder, and the StreamFeeder loop drains fixed-size batches (padding the
tail with repeats so device shapes stay static), runs the pipeline,
and dispatches per-stream results.

A copy of ``nubomedia_vca_tpu/pipeline/scheduler.py`` over the port's
``cpp/ingest_binding.make_ingest``; `process_batch` receives host frames
and uploads them to its models' device itself.
"""

from __future__ import annotations

import threading

import numpy as np

from ..cpp.ingest_binding import make_ingest
from ..utils.tracing import trace, count


class StreamFeeder:
    def __init__(self, width: int, height: int, batch: int = 16,
                 capacity: int = 512, work: tuple[int, int] | None = None):
        """work=(work_w, work_h): downscale at push (bit-exact
        INTER_LINEAR_EXACT, same tables as ops/resize.py) so batches are
        working-resolution luma and H2D traffic shrinks ~(W/work_w)² —
        the device resize becomes an identity, results unchanged."""
        self.w, self.h = width, height
        self.batch = batch
        self.ingest = make_ingest(width, height, capacity)
        if work is not None:
            self.ingest.set_work(*work)
        self._stop = threading.Event()

    def push(self, stream: int, frame, pts: int = 0):
        self.ingest.push(stream, frame, pts)

    def next_batch(self):
        """Collect up to `batch` ready frames, padded to the static batch
        size. Returns (frames [batch,H,W], pts, stream_ids, n_real)."""
        with trace("feeder/collect"):
            frames, pts, streams = self.ingest.collect(self.batch,
                                                       min_frames=1,
                                                       wait_ms=0)
        n = len(frames)
        if n == 0:
            return None
        if n < self.batch:  # pad with the last frame → static device shapes
            pad = self.batch - n
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], pad, axis=0)])
            pts = np.concatenate([pts, np.repeat(pts[-1:], pad)])
            streams = np.concatenate([streams, np.full(pad, -1, np.int32)])
        count("feeder/frames", n)
        return frames, pts, streams, n

    def run(self, process_batch, on_result=None):
        """Blocking loop: process_batch(frames)->results;
        on_result(stream, pts, result) per real frame."""
        while not self._stop.is_set():
            nb = self.next_batch()
            if nb is None:
                self._stop.wait(0.002)
                continue
            frames, pts, streams, n = nb
            with trace("feeder/process"):
                results = process_batch(frames)
            if on_result is not None:
                for i in range(n):
                    on_result(int(streams[i]), int(pts[i]), results[i])

    def stop(self):
        self._stop.set()
