"""survivor_ms.archive: device ms a call of the survivor stages
(``cascade/engine.py`` ``_level_post``, inside the benchmark's
``vcabench.survivor`` range): the device time of the kernels they launch,
summed over the traced calls and divided by the calls."""


def read(ctx: dict):
    tr = ctx["trace"]
    calls = len(tr.ranges.get("vcabench.process") or [])
    post = tr.ranges.get("vcabench.survivor") or []
    if not calls or not post:
        return None
    return sum(d for _, _, d in post) / calls / 1000.0
