"""Tracing / profiling (SURVEY.md §5).

The reference's observability was GStreamer debug categories plus ad-hoc
gettimeofday deltas (mostly commented out; kmsfacedetect.cpp:866-895,
kmsnosedetect.cpp:929-955 writing /tmp/nose.log). This replaces that with:

  * `trace(name)` — wall-clock section timers with running stats
  * per-filter frame/detection counters
  * `device_profile(path)` — the PyTorch profiler with CUDA activity, which
    writes a Chrome trace into the directory

A copy of ``nubomedia_vca_tpu/utils/tracing.py`` whose device profiler,
``jax.profiler`` there, is ``torch.profiler`` here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class SectionStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / self.count if self.count else 0.0


class Tracer:
    def __init__(self):
        self.sections: dict[str, SectionStats] = defaultdict(SectionStats)
        self.counters: dict[str, int] = defaultdict(int)
        self.enabled = True

    @contextlib.contextmanager
    def trace(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.sections[name]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)

    def count(self, name: str, n: int = 1):
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
trace = TRACER.trace
count = TRACER.count


@contextlib.contextmanager
def device_profile(logdir: str):
    """Device profiling around a region: ``torch.profiler`` over the CPU
    and, when CUDA is present, the card; on exit the Chrome trace goes to
    ``logdir/trace_<pid>_<n>.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` sums
    the time by kernel."""
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
