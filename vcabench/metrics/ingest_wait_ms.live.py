"""ingest_wait_ms.live: the mean wait (ms) of a frame in the ingest's
queue, from its push to the media loop's collect, over the window, from
the program's counters ``vca.ingest.wait_us`` and ``vca.ingest.frames``
(``api/media_loop.py``, ``cpp/ingest_binding.py``; counting while the
profiler records)."""


def read(ctx: dict):
    from nubomedia_vca_tpu_torch.utils.tracing import TRACER
    frames = TRACER.counters.get("vca.ingest.frames", 0)
    if not frames:
        return None
    return TRACER.counters.get("vca.ingest.wait_us", 0) / frames / 1000.0
