"""overflow_share.archive: the share (%) of the frames detected in the
traced calls on which an engine of the call set its overflow flag (more
survivors than its capacity: windows dropped), from the program's
counters ``vca.engine.overflow_frames`` and ``vca.filter.frames_detected``
(``utils/tracing.TRACER``, counting while the profiler records)."""


def read(ctx: dict):
    from nubomedia_vca_tpu_torch.utils.tracing import TRACER
    frames = TRACER.counters.get("vca.filter.frames_detected", 0)
    if not frames:
        return None
    return 100.0 * TRACER.counters.get("vca.engine.overflow_frames",
                                       0) / frames
