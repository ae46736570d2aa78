"""blobs_seeded.tracker: seeded motion components a frame, before the
area filter and the merge (segmentMotion's rects), from the program's
counters ``vca.tracker.blobs_seeded`` and ``vca.tracker.frames``
(``models/tracker.py``; counting while the profiler records)."""


def read(ctx: dict):
    from nubomedia_vca_tpu_torch.utils.tracing import TRACER
    frames = TRACER.counters.get("vca.tracker.frames", 0)
    if not frames or "vca.tracker.blobs_seeded" not in TRACER.counters:
        return None
    return TRACER.counters["vca.tracker.blobs_seeded"] / frames
