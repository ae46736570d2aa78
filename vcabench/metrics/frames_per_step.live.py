"""frames_per_step.live: frames a media-loop step takes (the batching the
loop achieves), from the benchmark's wrapper around ``_step``."""


def read(ctx: dict):
    if not ctx.get("steps"):
        return None
    return ctx["step_frames"] / ctx["steps"]
