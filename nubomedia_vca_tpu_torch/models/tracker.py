"""Motion tracker — the PyTorch port of ``nubomedia_vca_tpu/models/tracker.py``
(the rebuild of NuboTracker, gstnubotracker.cpp).

Reference per-frame pipeline (gstnubotracker.cpp:339-421): gray convert,
absdiff vs previous frame, binary threshold (default 20), motion-history
update (MHI_DURATION 0.2), motion gradient, segmentMotion into blob rects,
area filter (min 50 / max 30000) + distance merge (35 px) of blobs, draw +
rate-limited "tracker-event" signal.

Device design, as in the JAX package: the per-frame step runs on the
device with carried state (previous gray frame + MHI). Segmentation
(OpenCV's floodfill-based cvSegmentMotion) is seeded connected components:
pixels are 4-connected when their MHI timestamps differ by at most
seg_thresh, each is labelled with its component's raster-first pixel, and
a component is reported iff it contains a current-timestamp (seed) pixel.
Blob bounding boxes come from scatter-min/max over component roots; the
area filter and distance merge run on the host with the reference's exact
iteration order (__join_objects, gstnubotracker.cpp:171-200), copied from
the JAX package.

One compaction of the components: ``segment_motion`` reports every
seeded component in segmentMotion's order, the raster order of each
component's first seed pixel, since ``join_objects`` keeps the first merge
partner it finds. The JAX package caps the components in root order; the
port's parity tests rebuild that compaction over the port's labels. No
motion gradient is computed: no blob depends on it.

What runs where, chosen by the MHI's device:

* a CUDA tensor is labelled by one hand-written kernel
  (``ops/cuda/motion_ccl_cuda.py``, ``csrc/motion_ccl.cu``): block-based
  union-find in three launches a frame, no host read;
* a CPU tensor runs ``_propagate``, the JAX package's ``lax.while_loop``
  of min-label propagation with pointer jumping as a Python loop whose
  exit test reads a "changed" flag once every ``SEG_CHECK_EVERY``
  iterations. That is exact: labels only decrease, so an unchanged label
  map after a group of iterations means every iteration of the group was
  at the fixed point, where an iteration changes nothing. It is the plain
  version that the kernel is held to, label for label.

Units: timestamps are pts seconds as float32, as in the JAX package (the
reference's CPU-clock milliseconds collapse the MHI to the current
silhouette).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cascade.engine import _resolve_device
from ..ops.cuda import motion_ccl_cuda
from ..utils.tracing import count, trace

# label-propagation iterations between two reads of the "changed" flag
# (the plain loop, ``_propagate``)
SEG_CHECK_EVERY = 4


@dataclasses.dataclass
class TrackerConfig:
    """Knobs mirror the GObject properties (gstnubotracker.cpp:22-33)."""

    threshold: int = 20         # binary diff threshold
    min_area: int = 50
    max_area: int = 30000
    distance: int = 35          # blob merge distance
    visual_mode: int = 0
    activate_events: int = 0    # "server events"
    events_ms: int = 30001
    mhi_duration: float = 0.2
    seg_thresh: float = 0.05


@dataclasses.dataclass
class TrackerState:
    prev_gray: torch.Tensor    # [H, W] uint8
    mhi: torch.Tensor          # [H, W] float32
    initialized: torch.Tensor  # [] bool

    @classmethod
    def from_numpy(cls, prev_gray, mhi, initialized,
                   device: str | torch.device = "cuda") -> "TrackerState":
        """A state from host arrays (for example a JAX package state's
        fields through ``np.asarray``), on `device`."""
        dev = _resolve_device(device)
        return cls(
            prev_gray=torch.from_numpy(
                np.array(prev_gray, np.uint8)).to(dev),
            mhi=torch.from_numpy(np.array(mhi, np.float32)).to(dev),
            initialized=torch.tensor(bool(np.asarray(initialized)),
                                     device=dev))


def init_state(h: int, w: int,
               device: str | torch.device = "cuda") -> TrackerState:
    dev = _resolve_device(device)
    return TrackerState(
        prev_gray=torch.zeros((h, w), dtype=torch.uint8, device=dev),
        mhi=torch.zeros((h, w), dtype=torch.float32, device=dev),
        initialized=torch.zeros((), dtype=torch.bool, device=dev),
    )


_SHIFTS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _links(mhi, seg_thresh) -> torch.Tensor:
    """[4, H, W] bool: per direction of ``_SHIFTS``, whether a pixel and
    its neighbour there are linked: both MHI values non-zero, within
    `seg_thresh` of each other, and the neighbour inside the frame (a
    roll wraps around the edge)."""
    H, W = mhi.shape
    dev = mhi.device
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    edges = (rows == 0, rows == H - 1, cols == 0, cols == W - 1)
    # zero-MHI pixels are never part of a motion segment (OpenCV pre-marks
    # them in the floodfill mask)
    out = []
    for shift, edge in zip(_SHIFTS, edges):
        nb_val = torch.roll(mhi, shift, dims=(0, 1))
        out.append(((mhi - nb_val).abs() <= seg_thresh) & ~edge
                   & (mhi > 0) & (nb_val > 0))
    return torch.stack(out)


def _step(lab, links):
    """One iteration: the least label over a pixel and its linked
    neighbours, then pointer jumping (adopt the label of my label's
    pixel)."""
    n = lab.numel()
    m = lab
    for shift, connected in zip(_SHIFTS, links):
        nb_lab = torch.roll(lab, shift, dims=(0, 1))
        m = torch.minimum(m, torch.where(connected, nb_lab, n))
    return torch.minimum(m, m.reshape(-1)[m])


def _propagate(mhi, seg_thresh, iterations=None) -> torch.Tensor:
    """Component labels of the 4-neighbor |Δmhi| <= seg_thresh graph over
    the non-zero MHI pixels: [H*W] int64, each pixel labelled with its
    component's root, the component's raster-first pixel (a zero-MHI
    pixel is its own root). The plain loop, on any device: min-label
    propagation with pointer jumping, one host read of the "changed" flag
    every ``SEG_CHECK_EVERY`` iterations. Appends the iterations run to
    `iterations` when given."""
    H, W = mhi.shape
    links = _links(mhi, seg_thresh)
    n_iter = 0
    labels = torch.arange(H * W, dtype=torch.int64,
                          device=mhi.device).reshape(H, W)
    while True:
        before = labels
        for _ in range(SEG_CHECK_EVERY):
            labels = _step(labels, links)
        n_iter += SEG_CHECK_EVERY
        if torch.equal(labels, before):
            break
    if iterations is not None:
        iterations.append(n_iter)
    return labels.reshape(-1)


def _reduce(lab_flat, init, src, how):
    """Per-root reduction of the per-pixel `src` ([H*W] int32)."""
    out = torch.full(lab_flat.shape, init, dtype=torch.int32,
                     device=lab_flat.device)
    return out.scatter_reduce_(0, lab_flat, src, how, include_self=True)


def _boxes(lab_flat, sel, H, W):
    """[K,4] int32 x,y,w,h: the bounding boxes of the components whose
    roots are `sel`."""
    dev = lab_flat.device
    ys = torch.arange(H, device=dev, dtype=torch.int32)[:, None].expand(
        H, W).reshape(-1)
    xs = torch.arange(W, device=dev, dtype=torch.int32)[None, :].expand(
        H, W).reshape(-1)
    big = 1 << 30
    rx, ry = (_reduce(lab_flat, big, xs, "amin")[sel],
              _reduce(lab_flat, big, ys, "amin")[sel])
    rw = _reduce(lab_flat, -1, xs, "amax")[sel] - rx + 1
    rh = _reduce(lab_flat, -1, ys, "amax")[sel] - ry + 1
    return torch.stack([rx, ry, rw, rh], dim=-1)


def segment_motion(mhi, ts, seg_thresh, iterations=None) -> torch.Tensor:
    """cv::motempl::segmentMotion's rects: every component of the
    4-neighbor |Δmhi| <= seg_thresh graph over the non-zero MHI pixels
    that holds a pixel of timestamp `ts`, as [K,4] int32 x,y,w,h, however
    many there are, in the raster order of each component's first such
    (seed) pixel, the order in which segmentMotion's scan starts their
    flood fills. A CUDA MHI is labelled by the kernel
    (``motion_ccl_cuda.motion_ccl``), any other by ``_propagate``, which
    appends its iterations to `iterations` when given. Reads the number
    of components (one sync)."""
    H, W = mhi.shape
    n = H * W
    if mhi.device.type == "cuda":
        lab_flat = motion_ccl_cuda.motion_ccl(mhi, seg_thresh)
    else:
        lab_flat = _propagate(mhi, seg_thresh, iterations)
    flat_idx = torch.arange(n, dtype=torch.int64, device=mhi.device)
    seed = ((mhi == ts) & (mhi > 0)).reshape(-1)
    first_seed = _reduce(lab_flat, n, torch.where(seed, flat_idx, n).to(
        torch.int32), "amin")
    roots = torch.nonzero((lab_flat == flat_idx) & (first_seed < n))[:, 0]
    sel = roots[torch.argsort(first_seed[roots])]
    return _boxes(lab_flat, sel, H, W)


def _as_uint8(x, dev: torch.device) -> torch.Tensor:
    """A uint8 tensor on `dev` from a tensor or a host array."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.uint8))
    return x.to(dev, torch.uint8)


def _update(state: TrackerState, gray, ts, threshold, mhi_duration):
    """absdiff, threshold and updateMotionHistory of one frame → (the new
    state, the frame's timestamp as a float32 tensor). The first frame of
    a state leaves its MHI as it is."""
    dev = state.mhi.device
    gray = _as_uint8(gray, dev)
    diff = (gray.to(torch.int32) - state.prev_gray.to(torch.int32)).abs()
    silh = diff > threshold                       # cv::threshold(.., thr, 255)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)
    # float32 throughout: ts - mhi_duration stays a float32 tensor
    mhi = torch.where(silh, ts, torch.where(
        state.mhi < ts - mhi_duration, 0.0, state.mhi))
    mhi = torch.where(state.initialized, mhi, state.mhi)  # first frame: no-op
    return TrackerState(prev_gray=gray, mhi=mhi,
                        initialized=torch.ones((), dtype=torch.bool,
                                               device=dev)), ts


# ----------------------------------------------------------------- host layer
def _calc_dist(r1, r2):
    c1 = (r1[0] + r1[2] / 2, r1[1] + r1[3] / 2)
    c2 = (r2[0] + r2[2] / 2, r2[1] + r2[3] / 2)
    return np.sqrt((c1[0] - c2[0]) ** 2 + (c1[1] - c2[1]) ** 2)


def _merge_rects(r1, r2):
    """__merge (gstnubotracker.cpp:131-169): containment or union box."""
    x1, y1 = min(r1[0], r2[0]), min(r1[1], r2[1])
    x2 = max(r1[0] + r1[2], r2[0] + r2[2])
    y2 = max(r1[1] + r1[3], r2[1] + r2[3])
    return (x1, y1, x2 - x1, y2 - y1)


def join_objects(rects, min_area, max_area, distance):
    """__join_objects (gstnubotracker.cpp:171-200): back-to-front area filter
    plus pairwise distance merge with the reference's exact ordering."""
    rs = [tuple(int(v) for v in r) for r in rects]
    a = len(rs) - 1
    while a >= 0:
        area = rs[a][2] * rs[a][3]
        if min_area < area < max_area:
            for b in range(a - 1, -1, -1):
                area_b = rs[b][2] * rs[b][3]
                if min_area < area_b < max_area and \
                        distance > _calc_dist(rs[a], rs[b]):
                    rs[b] = _merge_rects(rs[a], rs[b])
                    del rs[a]
                    break
        else:
            del rs[a]
        a -= 1
    return rs


class Tracker:
    """Stateful wrapper with the reference's host-side blob filtering. The
    MHI/prev-frame recurrence state is kept PER STREAM (keyed by the media
    loop's stream id); the reference's file-static `img_prev` shared across
    instances (gstnubotracker.cpp:108) is a documented hazard fixed, not
    reproduced. Runs on the card unless the caller asks for another
    device; a CUDA request on a host without CUDA raises."""

    def __init__(self, frame_size: tuple[int, int],
                 config: TrackerConfig | None = None, fps: float = 30.0,
                 device: str | torch.device = "cuda"):
        self.device = _resolve_device(device)
        self.config = config or TrackerConfig()
        self.w, self.h = frame_size
        self.fps = fps
        self._states: dict[int, TrackerState] = {
            0: init_state(self.h, self.w, self.device)}
        self._frame_idx: dict[int, int] = {0: 0}
        if self.device.type == "cuda":
            motion_ccl_cuda.load()      # built now, not by a frame

    # stream-0 views keep the single-stream surface
    @property
    def state(self) -> TrackerState:
        return self._states[0]

    @state.setter
    def state(self, v: TrackerState) -> None:
        self._states[0] = v

    @property
    def frame_idx(self) -> int:
        return self._frame_idx[0]

    @frame_idx.setter
    def frame_idx(self, v: int) -> None:
        self._frame_idx[0] = v

    def reconfigure(self, config: TrackerConfig) -> None:
        """Apply a config delta to the live tracker; MHI recurrence state
        and frame clocks survive (the reference mutates the running element
        under its mutex, gst_nubo_tracker_set_property)."""
        self.config = config

    def process(self, gray_frames,
                stream: int = 0) -> list[list[tuple[int, int, int, int]]]:
        """Consecutive frames [N,H,W] (or [H,W]) of one stream → per-frame
        blob lists: segmentMotion's components (`segment_motion`: every
        one, in its order), then the area filter and merge. The frames
        are uploaded once and the rects of all N frames come back to the
        host in one copy. No motion gradient is computed: no blob depends
        on it. On a CUDA device each frame's components are labelled by
        the union-find kernel (three launches, no host read; counted in
        ``vca.tracker.ccl_frames``), elsewhere by the plain loop (its
        iterations counted in ``vca.tracker.seg_iterations``)."""
        with trace("vca.tracker.process", {"stream": stream}):
            gray_frames = np.asarray(gray_frames)
            if gray_frames.ndim == 2:
                gray_frames = gray_frames[None]
            cfg = self.config
            state = self._states.get(stream)
            if state is None:
                state = init_state(self.h, self.w, self.device)
                self._frame_idx[stream] = 0
            idx = self._frame_idx[stream]
            count("vca.tracker.frames", len(gray_frames))
            with trace("vca.tracker.upload"):
                frames = _as_uint8(gray_frames, self.device)
            all_rects, iters = [], []
            for fr in frames:
                state, ts = _update(state, fr, idx / self.fps,
                                    cfg.threshold, cfg.mhi_duration)
                with trace("vca.tracker.segment"):
                    all_rects.append(segment_motion(
                        state.mhi, ts, cfg.seg_thresh, iters))
                idx += 1
            # a copy of the last frame: a view would keep the call's whole
            # batch of frames on the device for as long as the stream lives
            self._states[stream] = dataclasses.replace(
                state, prev_gray=state.prev_gray.clone())
            self._frame_idx[stream] = idx
            sizes = [len(r) for r in all_rects]
            if iters:       # the plain loop ran: the kernel counts none
                count("vca.tracker.seg_iterations", sum(iters))
            count("vca.tracker.blobs_seeded", sum(sizes))
            with trace("vca.tracker.fetch"):
                rects = torch.cat(all_rects).cpu().numpy()
            with trace("vca.tracker.join"):
                bounds = np.cumsum([0] + sizes)
                return [join_objects(rects[lo:hi], cfg.min_area,
                                     cfg.max_area, cfg.distance)
                        for lo, hi in zip(bounds[:-1], bounds[1:])]
