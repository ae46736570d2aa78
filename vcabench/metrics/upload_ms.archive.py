"""upload_ms.archive: the filter loop's upload a call (ms): the wall time
of the program's ``vca.filter.upload`` ranges (the gather of the frames
to detect, the bucket pad and the host-to-device copy; ``models/face.py``,
``models/parts.py``), summed over the traced calls and divided by the
calls (``vca.filter.process`` ranges)."""


def read(ctx: dict):
    host = ctx["trace"].host
    calls = sum(1 for n, _, _ in host if n == "vca.filter.process")
    spans = [(s, e) for n, s, e in host if n == "vca.filter.upload"]
    if not calls or not spans:
        return None
    return sum(e - s for s, e in spans) / calls / 1000.0
