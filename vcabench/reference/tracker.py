"""A plain version of NUBOMEDIA-VCA's motion tracker (NuboTracker) for the
benchmark's check: per frame, what ``gst_nubo_tracker_process``
(gstnubotracker.cpp:339-421) computes at its documented defaults.

* ``absdiff`` of the frame's luma against the previous frame's, binary
  ``threshold`` (a pixel moved if the difference exceeds it);
* ``updateMotionHistory``: a moved pixel takes the frame's timestamp, a
  pixel older than ``timestamp - mhi_duration`` goes to 0, the rest keep
  theirs;
* ``segmentMotion`` (opencv_contrib ``optflow/src/motempl.cpp``): a scan
  of the frame in raster order starts a flood fill at each pixel that
  holds the current timestamp and that no earlier fill reached; a fill
  takes the 4-neighbours whose MHI differs from the pixel it comes from
  by at most ``seg_thresh``, never a zero pixel; each fill gives its
  bounding box. So the boxes are those of the components of that graph
  over the non-zero pixels which hold a current-timestamp pixel, in the
  raster order of each component's first such pixel, with no cap on
  their number;
* ``__join_objects`` / ``__merge`` (gstnubotracker.cpp:131-200): from the
  last box to the first, a box outside (min_area, max_area) is dropped;
  one inside merges with the first earlier box, scanning back, that is
  inside too and whose centre lies nearer than ``distance``, the two
  becoming their union box in the earlier place.

The components are found here by plain min-label propagation along an
edge list of the non-zero pixels, checked after every iteration: each
node takes the smallest label among itself and its neighbours until no
label changes. The frames of a call are segmented together (their MHIs
are computed first, one after the other, since the segmentation feeds
nothing back), and the MHI is computed in ``prec``: float32 as the
configuration states, or another dtype for the check's control.

Departures from the element, each forced by the port's contract:

* state (the previous frame, the MHI, the frame count) is per stream; the
  element's file-static ``img_prev`` (gstnubotracker.cpp:108), shared by
  every instance, is a hazard not reproduced;
* the first frame of a stream reports nothing (there is no previous
  frame to difference against);
* timestamps are pts seconds, ``float32(frame index / fps)``, and
  ``timestamp - mhi_duration`` is computed in ``prec`` (the element reads
  the CPU clock in milliseconds, which collapses the MHI to the current
  silhouette);
* ``calcMotionGradient`` is not computed: no box depends on it.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _center(r):
    return (r[0] + r[2] / 2, r[1] + r[3] / 2)


def _merge(a, b):
    """__merge: the union box of a and b (a box inside the other gives
    the outer one)."""
    x0, y0 = min(a[0], b[0]), min(a[1], b[1])
    x1, y1 = max(a[0] + a[2], b[0] + b[2]), max(a[1] + a[3], b[1] + b[3])
    return (x0, y0, x1 - x0, y1 - y0)


def join_objects(boxes: list[tuple], min_area: int, max_area: int,
                 distance: int) -> list[tuple]:
    """__join_objects over the boxes in segmentMotion's order."""
    out = list(boxes)
    i = len(out) - 1
    while i >= 0:
        area = out[i][2] * out[i][3]
        if not min_area < area < max_area:
            del out[i]
        else:
            ci = _center(out[i])
            for j in range(i - 1, -1, -1):
                cj = _center(out[j])
                if min_area < out[j][2] * out[j][3] < max_area and \
                        math.hypot(ci[0] - cj[0], ci[1] - cj[1]) < distance:
                    out[j] = _merge(out[i], out[j])
                    del out[i]
                    break
        i -= 1
    return out


def segment(mhi: torch.Tensor, ts: torch.Tensor, seg_thresh: float,
            report: list[bool]) -> list[list[tuple]]:
    """segmentMotion's boxes of each frame of mhi [T, H, W] at its
    timestamp ts [T] (both in the MHI's dtype); a frame whose `report` is
    False gives none."""
    T, H, W = mhi.shape
    dev = mhi.device
    flat = mhi.reshape(-1)
    nodes = torch.nonzero(flat != 0)[:, 0]          # (t, y, x) ascending
    out: list[list[tuple]] = [[] for _ in range(T)]
    if not len(nodes):
        return out
    near = []
    for axis, step in ((2, 1), (1, W)):             # right, down
        a = mhi.narrow(axis, 0, mhi.shape[axis] - 1)
        b = mhi.narrow(axis, 1, mhi.shape[axis] - 1)
        ok = torch.zeros_like(mhi, dtype=torch.bool)
        ok.narrow(axis, 0, mhi.shape[axis] - 1).copy_(
            (a != 0) & (b != 0) & ((a - b).abs() <= seg_thresh))
        p = torch.nonzero(ok.reshape(-1))[:, 0]
        near.append((p, p + step))
    p = torch.cat([e[0] for e in near])
    q = torch.cat([e[1] for e in near])
    u, v = torch.searchsorted(nodes, p), torch.searchsorted(nodes, q)
    n = len(nodes)
    label = torch.arange(n, device=dev)
    while True:
        new = label.scatter_reduce(0, u, label[v], "amin")
        new.scatter_reduce_(0, v, label[u], "amin")
        if torch.equal(new, label):
            break
        label = new
    # a node's label is now its component's first node (raster order)
    t = nodes // (H * W)
    y = (nodes // W) % H
    x = nodes % W
    rep = torch.tensor(report, device=dev)
    seed = (flat[nodes] == ts[t]) & rep[t]
    first_seed = torch.full((n,), n, device=dev).scatter_reduce(
        0, label, torch.where(seed, torch.arange(n, device=dev), n), "amin")
    roots = torch.nonzero((label == torch.arange(n, device=dev))
                          & (first_seed < n))[:, 0]
    roots = roots[torch.argsort(first_seed[roots])]

    def per_root(v, init, how):
        return torch.full((n,), init, device=dev).scatter_reduce(
            0, label, v, how)[roots]

    big = 1 << 30
    cols = torch.stack([t[roots], per_root(x, big, "amin"),
                        per_root(y, big, "amin"), per_root(x, -1, "amax"),
                        per_root(y, -1, "amax")], 1).cpu().numpy()
    for f, x0, y0, x1, y1 in cols.tolist():
        out[f].append((x0, y0, x1 - x0 + 1, y1 - y0 + 1))
    return out


class TrackerFilter:
    """The tracker of `cfg` (``threshold``, ``min_area``, ``max_area``,
    ``distance``, ``mhi_duration``, ``seg_thresh``, ``fps``, ``frame``)
    on `device`, its MHI in `prec`."""

    def __init__(self, cfg: dict, device, prec=torch.float32):
        # no float32 product may round through TF32 (none is taken here)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.prec = prec
        # stream → (previous frame, MHI, frames seen)
        self.state: dict[int, tuple] = {}

    def process(self, stream: int, frames) -> list[list[tuple]]:
        """Consecutive luma frames [N, H, W] uint8 of one stream, in the
        order the stream sent them → each frame's boxes."""
        cfg = self.cfg
        g = torch.as_tensor(np.ascontiguousarray(frames)).to(self.device)
        dur = torch.tensor(cfg["mhi_duration"], dtype=self.prec,
                           device=self.device)
        prev, mhi, seen = self.state.get(stream, (None, None, 0))
        if mhi is None:
            mhi = torch.zeros(g.shape[1:], dtype=self.prec,
                              device=self.device)
        mhis, stamps, report = [], [], []
        for fr in g:
            ts = torch.tensor(seen / cfg["fps"], dtype=torch.float32).to(
                self.device, self.prec)
            if prev is not None:
                moved = (fr.int() - prev.int()).abs() > cfg["threshold"]
                mhi = torch.where(moved, ts, torch.where(
                    mhi < ts - dur, torch.zeros_like(mhi), mhi))
            mhis.append(mhi)
            stamps.append(ts)
            report.append(prev is not None)
            prev, seen = fr, seen + 1
        self.state[stream] = (prev, mhi, seen)
        boxes = segment(torch.stack(mhis), torch.stack(stamps),
                        cfg["seg_thresh"], report)
        return [join_objects(b, cfg["min_area"], cfg["max_area"],
                             cfg["distance"]) for b in boxes]
