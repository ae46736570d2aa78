"""loop_step_ms.live: mean host ms of a media-loop step
(``api/media_loop.py`` ``MediaRunner._step``: the elements, the render and
the write-back of one stream's collected frames), from the benchmark's
wrapper around it, over the window."""


def read(ctx: dict):
    if not ctx.get("steps"):
        return None
    return 1000.0 * ctx["step_seconds"] / ctx["steps"]
