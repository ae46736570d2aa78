"""Reading a ``torch.profiler`` trace of a benchmark window.

The idea of the program's ``tools/profile_torch_{face,parts}.py`` (the
device activity of the profiler, busy time against wall time, device time
by op), kept here so that later changes to the program cannot move the
yardstick. Times are in microseconds on the profiler's clock, which the
host ranges (``record_function``) and the device activity share.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Trace:
    """What the metric readers take from a profiled window."""

    # device activity (kernels, copies, sets): (name, start, end)
    device: list[tuple[str, float, float]]
    # host ranges opened by the benchmark: name -> [(start, end, device
    # time of the kernels launched inside)]
    ranges: dict[str, list[tuple[float, float, float]]]
    # host ops and runtime calls, for naming what the host did in a gap
    host: list[tuple[str, float, float]]
    window: tuple[float, float]

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self, lo: float | None = None, hi: float | None = None,
                ) -> float:
        """Length of the union of device activity inside [lo, hi]."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        total, end = 0.0, lo
        for _, s, e in self.device:          # sorted by start
            s, e = max(s, end), min(e, hi)
            if e > s:
                total += e - s
                end = e
            if s >= hi:
                break
        return total

    def kernel_us(self, names: tuple[str, ...]) -> float:
        """Summed device time of the activity whose name holds one of
        `names`."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names))

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:96], v * 1e-6] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The k longest stretches of the window with no device activity,
        each named by the innermost host op or range running at its
        middle."""
        gaps, end = [], self.window[0]
        for _, s, e in self.device:
            if s > end:
                gaps.append((end, min(s, self.window[1])))
            end = max(end, e)
            if end >= self.window[1]:
                break
        if end < self.window[1]:
            gaps.append((end, self.window[1]))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:k]
        out = []
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            inner = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            out.append([min(inner)[1][:96] if inner else "host: no op",
                        (hi - lo) * 1e-6])
        return out


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def summarize(prof, range_names: tuple[str, ...],
              window_range: str | None) -> Trace:
    """A finished ``torch.profiler.profile`` → Trace. `range_names` are
    the benchmark's ``record_function`` names to keep; the window runs
    from the first `window_range` range's start to the last one's end,
    or, without such ranges, over the device's activity."""
    device, host = [], []
    ranges: dict[str, list] = {n: [] for n in range_names}
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name in ranges:
                continue
            device.append((e.name, s, t))
        else:
            if e.name in ranges:
                ranges[e.name].append((s, t, _device_us(e)))
            host.append((e.name, s, t))
    device.sort(key=lambda d: d[1])
    win = ranges.get(window_range) or []
    window = ((min(r[0] for r in win), max(r[1] for r in win)) if win
              else (device[0][1], max(d[2] for d in device)) if device
              else (0.0, 0.0))
    return Trace(device, ranges, host, window)
