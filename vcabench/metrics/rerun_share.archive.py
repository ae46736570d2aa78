"""rerun_share.archive: frames the face filter ran again on a wider
engine (their survivors outgrew a capacity; a frame once for each wider
engine it took) as a share (%) of the frames detected in the traced
calls, from the program's counters ``vca.engine.rerun_frames`` and
``vca.filter.frames_detected`` (``models/face.py``; counting while the
profiler records)."""


def read(ctx: dict):
    from nubomedia_vca_tpu_torch.utils.tracing import TRACER
    frames = TRACER.counters.get("vca.filter.frames_detected", 0)
    if not frames or "vca.engine.rerun_frames" not in TRACER.counters:
        return None
    return 100.0 * TRACER.counters["vca.engine.rerun_frames"] / frames
