"""emit_ms.live: host ms a media-loop step spends rendering the
detections, copying the frames back and queueing them on the stream's
connection (``api/media_loop.py`` ``_emit_annotated``, the program's
``vca.media.emit`` section) over the window, divided by the steps
(``vca.media.step``); host clock (``utils/tracing.TRACER``, recording
while the profiler records)."""


def read(ctx: dict):
    from nubomedia_vca_tpu_torch.utils.tracing import TRACER
    steps = TRACER.sections.get("vca.media.step")
    part = TRACER.sections.get("vca.media.emit")
    if steps is None or part is None or not steps.count:
        return None
    return 1000.0 * part.total_s / steps.count
