"""Tracing / profiling (SURVEY.md §5).

The reference's observability was GStreamer debug categories plus ad-hoc
gettimeofday deltas (mostly commented out; kmsfacedetect.cpp:866-895,
kmsnosedetect.cpp:929-955 writing /tmp/nose.log). This replaces that with:

  * `trace(name, args)` — a span: host-clock section stats (count,
    total, max) and, while ``torch.profiler`` records, a
    ``record_function`` range on the profiler's own clock, beside every
    kernel and copy the span launches
  * `count(name, n)` — counters, under the same gate
  * `device_profile(path)` — the PyTorch profiler with CUDA activity, which
    writes a Chrome trace into the directory

Names follow ``vca.<layer>.<stage>``: ``vca.filter.*`` (the filter loop's
``process``: upload, fetch, track), ``vca.engine.*`` (the cascade engine:
dense, survivor, group), ``vca.media.*`` (the media loop: collect, step,
elements, emit) and ``vca.ingest.*`` (the wait of frames in the ingest).
The stream feeder keeps its ``feeder/*`` sections.

**The gate.** A span or count does anything only while the tracer is
enabled or the profiler records (``torch.autograd.profiler.
_is_profiler_enabled``, set by every ``torch.profiler.profile``, CUDA-only
ones too). Otherwise `trace` returns a shared no-op context after that one
test: no ``record_function``, no allocation, well under a microsecond a
span (a face call of 64 frames opens about 14 spans, an eye call about
110). The module's `TRACER` starts disabled.

**How an operator gets the spans.** In a Chrome trace: run the region
under `device_profile(logdir)` and open the file in Perfetto; the
program's ranges sit above the kernels they launched. As a report: set
``TRACER.enabled = True``, run, ``print(TRACER.report())``.

A copy of ``nubomedia_vca_tpu/utils/tracing.py`` whose device profiler,
``jax.profiler`` there, is ``torch.profiler`` here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict

import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()     # reusable: the span of a closed gate


@dataclasses.dataclass
class SectionStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / self.count if self.count else 0.0


class _Span:
    """One open span: the host clock, and a profiler range while the
    profiler records."""

    __slots__ = ("tracer", "name", "args", "rf", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self.tracer, self.name, self.args = tracer, name, args
        self.rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            args = (", ".join(f"{k}={v}" for k, v in self.args.items())
                    if self.args else None)
            self.rf = _autograd_profiler.record_function(self.name, args)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.tracer._add(self.name, dt)
        return False


class Tracer:
    def __init__(self):
        self.sections: dict[str, SectionStats] = defaultdict(SectionStats)
        self.counters: dict[str, int] = defaultdict(int)
        self.enabled = True
        self._lock = threading.Lock()   # loop threads share the stats

    def active(self) -> bool:
        """Whether spans and counts record: the tracer is enabled or the
        profiler records."""
        return self.enabled or _autograd_profiler._is_profiler_enabled

    def trace(self, name: str, args: dict | None = None):
        """A span named `name` (a context manager); `args` (e.g.
        ``{"stream": 3}``) become the profiler range's argument string."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, name, args)

    def _add(self, name: str, dt: float) -> None:
        with self._lock:
            s = self.sections[name]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)

    def count(self, name: str, n: int = 1):
        if self.enabled or _autograd_profiler._is_profiler_enabled:
            with self._lock:
                self.counters[name] += n

    def report(self) -> str:
        lines = ["=== vca trace ==="]
        for name, s in sorted(self.sections.items()):
            lines.append(f"{name:36s} n={s.count:6d} mean={s.mean_ms:8.2f}ms "
                         f"max={s.max_s * 1000:8.2f}ms")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name:36s} count={v}")
        return "\n".join(lines)


TRACER = Tracer()
TRACER.enabled = False      # spans record only while the profiler does
trace = TRACER.trace
count = TRACER.count
active = TRACER.active


@contextlib.contextmanager
def device_profile(logdir: str):
    """Device profiling around a region: ``torch.profiler`` over the CPU
    and, when CUDA is present, the card; on exit the Chrome trace goes to
    ``logdir/trace_<pid>_<n>.json`` (open it in Perfetto or
    chrome://tracing), with the program's spans (``vca.*``) as ranges
    above the kernels they launched. Yields the profiler, whose
    ``key_averages()`` sums the time by kernel and by span."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the region's kernels end inside
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))
