"""seg_iterations.tracker: label-propagation iterations a frame of the
tracker's segmentation, from the program's counters
``vca.tracker.seg_iterations`` and ``vca.tracker.frames``
(``models/tracker.py``; counting while the profiler records)."""


def read(ctx: dict):
    from nubomedia_vca_tpu_torch.utils.tracing import TRACER
    frames = TRACER.counters.get("vca.tracker.frames", 0)
    if not frames or "vca.tracker.seg_iterations" not in TRACER.counters:
        return None
    return TRACER.counters["vca.tracker.seg_iterations"] / frames
