"""track_ms.archive: the filter loop's host stage after the device pass a
call (ms): the wall time of the program's ``vca.filter.track`` ranges
(tracking; for the part filters the ROI split, merge and smoothing),
summed over the traced calls and divided by the calls
(``vca.filter.process`` ranges)."""


def read(ctx: dict):
    host = ctx["trace"].host
    calls = sum(1 for n, _, _ in host if n == "vca.filter.process")
    spans = [(s, e) for n, s, e in host if n == "vca.filter.track"]
    if not calls or not spans:
        return None
    return sum(e - s for s, e in spans) / calls / 1000.0
