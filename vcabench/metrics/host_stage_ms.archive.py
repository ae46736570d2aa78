"""host_stage_ms.archive: the filter loop's host time a call (ms): the
wall time of each traced ``process`` call (the benchmark's
``vcabench.process`` range) less the time the device was busy inside it,
summed and divided by the calls."""


def read(ctx: dict):
    tr = ctx["trace"]
    spans = tr.ranges.get("vcabench.process") or []
    if not spans:
        return None
    host = sum((e - s) - tr.busy_us(s, e) for s, e, _ in spans)
    return host / len(spans) / 1000.0
