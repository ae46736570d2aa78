"""backlog_frames.live: frames waiting in the ingests
(``cpp/ingest_binding.py``, ``MediaRunner.stats()["pending"]``, summed
over the cameras) at the window's end less at its start."""


def read(ctx: dict):
    return float(ctx["backlog"]) if "backlog" in ctx else None
