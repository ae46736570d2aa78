"""segment_ms.tracker: the tracker's segmentation a frame (ms): the wall
time of the program's ``vca.tracker.segment`` ranges (``models/tracker.py``
``segment_motion``, one a frame: label propagation with its host syncs,
then the compaction of the components), summed over the traced calls and
divided by the ranges."""


def read(ctx: dict):
    spans = [(s, e) for n, s, e in ctx["trace"].host
             if n == "vca.tracker.segment"]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1000.0
