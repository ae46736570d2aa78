"""Motion archive traffic: recorded footage of traffic and CCTV cameras
re-analysed for motion through the tracker's filter loop, the call the CLI
and ``NuboTracker`` make, ``Tracker.process`` with ``stream=s``.

The streams, calls, window and closed loop are the archive mix's
(``archive.py``): each stream's clip is drawn once from the seed
(``frozen/motion.py``) and handed over as host luma frames; a call takes
one stream's clip, the streams in turn, each clip played forward, then
backward. The tracker's state carries from call to call, so each pass of
a clip meets another motion history.

Before the window, as set-up, every stream plays its clip forward and
backward ``preroll_rounds`` times: the window finds each camera's
analysis under way, its motion history and clock running, as a
deployment does, and no frame of the window is a stream's first. (A
stream's clock is its frames so far over the frame rate; past about 4 s
a bfloat16 MHI no longer keeps adjacent timestamps apart as float32
does, so the pre-roll is also what lets the check tell the two apart.)

The check replays every call of every stream, the pre-roll's first, in
call order, through the plain reference (``reference/tracker.py``) with
its per-stream state carried, and compares each frame's blob list of the
window's calls, order included.
"""

from __future__ import annotations

import torch

from ..frozen import motion
from ..reference import tracker as ref
from . import archive


def _program(cfg: dict, device: torch.device):
    """The tracker of `cfg`, built as ``NuboTracker`` builds it."""
    from nubomedia_vca_tpu_torch.models.tracker import (Tracker,
                                                        TrackerConfig)
    return Tracker(tuple(cfg["frame"]), TrackerConfig(
        threshold=cfg["threshold"], min_area=cfg["min_area"],
        max_area=cfg["max_area"], distance=cfg["distance"],
        visual_mode=cfg["visual_mode"],
        activate_events=cfg["activate_events"],
        mhi_duration=cfg["mhi_duration"], seg_thresh=cfg["seg_thresh"]),
        fps=cfg["fps"], device=device)


class MotionArchive(archive.Archive):
    """One run of the motion archive mix: set-up, window, check."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, cascade_dir: str | None = None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = device
        self.cascade_dir = cascade_dir
        clips, self.layout = motion.clips(mix, tuple(cfg["frame"]), seed,
                                          device)
        # host luma frames, as a decoder hands the Y plane over
        self.pool = clips.cpu().numpy()
        del clips
        self.program = _program(cfg, device)
        self.batch = mix["batch"]
        if self.pool.shape[1] != self.batch:
            raise ValueError("a call takes one clip: batch == clip_frames")
        self.n_streams = self.pool.shape[0]
        self.preroll = [(s, d) for _ in range(mix["preroll_rounds"])
                        for d in (0, 1) for s in range(self.n_streams)]
        self.calls: list[tuple[int, int]] = []
        self.results: list = []

    def warm_up(self) -> None:
        """The pre-roll: every stream's clip, forward then backward,
        `preroll_rounds` times (the window's one call shape too)."""
        for s, d in self.preroll:
            self.program.process(self.frames(s, d), stream=s)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reference(self, prec=torch.float32):
        return ref.TrackerFilter(self.cfg, self.device, prec)

    def expected(self, flt) -> dict:
        """Reference results of every call of the window, in call order,
        each stream's state carried from its previous call, the
        pre-roll's first: {call index: [per-frame blob list]}."""
        for s, d in self.preroll:
            flt.process(s, self.frames(s, d))
        return {i: flt.process(s, self.frames(s, d))
                for i, (s, d) in enumerate(self.calls)}

    def compare(self, expected: dict, got: dict) -> tuple[int, int]:
        """(frames compared, frames whose blob list differs, order
        included); a missing call counts every frame as differing."""
        n = bad = 0
        for i, want in expected.items():
            have = got.get(i)
            for j, w in enumerate(want):
                n += 1
                if have is None or [tuple(int(v) for v in b)
                                    for b in have[j]] != w:
                    bad += 1
        return n, bad


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, cascade_dir: str) -> dict:
    """One run → the numbers ``run.py`` reports."""
    a = MotionArchive(cfg, mix, seed, device, cascade_dir)
    return archive._window(a, mix, seconds, trace, device, cfg, cascade_dir)
