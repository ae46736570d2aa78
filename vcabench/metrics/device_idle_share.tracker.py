"""device_idle_share.tracker: the share (%) of the traced window of the
tracker's calls in which no kernel, copy or set ran on the card."""


def read(ctx: dict):
    tr = ctx["trace"]
    if tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
