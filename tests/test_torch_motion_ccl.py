"""The motion labelling kernel's algorithm on the CPU: a numpy mirror of
``csrc/motion_ccl.cu``'s three passes, held label for label against the
plain loop that it replaces on the card (``models/tracker._propagate``).

The card alone runs the kernel (``tests/test_torch_cuda.py`` holds it to
``_propagate`` there). Here the mirror walks the same steps with the
tile as a parameter: pass 1 unions each tile's right and down links in
tile-local indices, larger root under smaller, and writes each pixel's
global parent, its local root mapped back to the frame; pass 2 unions
the linked pairs across the tiles' bottom and right borders on the
global parents; pass 3 writes each pixel's root. The unions of a pass
run in a shuffled order, as the kernel's threads do in no fixed one.
Tiles of 4x4, 8x8, 5x7 and the kernel's own 32x32 cut the maps
(``utils/synth.motion_maps``, MHIs of the blob clip) at sizes that no
tile divides.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu_torch.models import tracker
from nubomedia_vca_tpu_torch.ops.cuda import motion_ccl_cuda
from nubomedia_vca_tpu_torch.utils import tracing
from nubomedia_vca_tpu_torch.utils.synth import blob_clip, motion_maps

torch.set_num_threads(2)

SEG_THRESH = 0.05
H, W = 45, 53                  # no tile below divides either side
TILES = [(4, 4), (8, 8), (5, 7),
         (motion_ccl_cuda.TILE, motion_ccl_cuda.TILE)]
BLOB_SIZE = (160, 120)         # w, h of the blob clip's MHIs
BLOB_FRAMES = (3, 5, 7)        # frames of an 8-frame clip whose MHI is used


def _linked(a, b, thr) -> np.ndarray:
    """The kernel's link: both > 0 and |a - b| <= thr, in float32."""
    return (a > 0) & (b > 0) & (np.abs(a - b) <= thr)


def _find(p: list, i: int) -> int:
    while p[i] != i:
        i = p[i]
    return i


def _unite(p: list, a: int, b: int) -> None:
    """The kernel's union, one thread at a time: the larger root goes
    under the smaller (atomicMin), retried from the old parent when the
    root had moved."""
    while True:
        a, b = _find(p, a), _find(p, b)
        if a == b:
            return
        if a > b:
            a, b = b, a
        old = p[b]
        p[b] = min(old, a)
        if old == b:
            return
        b = old


def mirror_labels(mhi: np.ndarray, seg_thresh: float, tile: tuple[int, int],
                  rng) -> np.ndarray:
    """[H*W] int64 labels by the kernel's three passes, on tiles of
    `tile` (rows, columns)."""
    h, w = mhi.shape
    th, tw = tile
    thr = np.float32(seg_thresh)
    parent = [0] * (h * w)
    # pass 1: a tile at a time, in tile-local indices
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            t = np.zeros((th, tw), np.float32)   # 0 past the frame's edge
            piece = mhi[y0:y0 + th, x0:x0 + tw]
            t[:piece.shape[0], :piece.shape[1]] = piece
            right = _linked(t[:, :-1], t[:, 1:], thr)
            down = _linked(t[:-1], t[1:], thr)
            pairs = [(y * tw + x, y * tw + x + 1)
                     for y, x in zip(*np.nonzero(right))]
            pairs += [(y * tw + x, (y + 1) * tw + x)
                      for y, x in zip(*np.nonzero(down))]
            p = list(range(th * tw))
            for k in rng.permutation(len(pairs)):
                _unite(p, *pairs[k])
            for y in range(piece.shape[0]):
                for x in range(piece.shape[1]):
                    r = _find(p, y * tw + x)
                    parent[(y0 + y) * w + x0 + x] = ((y0 + r // tw) * w
                                                     + x0 + r % tw)
    # pass 2: pairs across the horizontal, then the vertical borders
    pairs = [(r * w + c, (r + 1) * w + c)
             for r in range(th - 1, h - 1, th) for c in range(w)]
    pairs += [(y * w + c, y * w + c + 1)
              for y in range(h) for c in range(tw - 1, w - 1, tw)]
    flat = mhi.reshape(-1)
    pairs = [(a, b) for a, b in pairs if _linked(flat[a], flat[b], thr)]
    for k in rng.permutation(len(pairs)):
        _unite(parent, *pairs[k])
    # pass 3: each pixel's root
    return np.array([_find(parent, i) for i in range(h * w)], np.int64)


def blob_mhis() -> list[np.ndarray]:
    """The MHIs of the blob clip after `BLOB_FRAMES`, as the tracker
    updates them (threshold 20, MHI 0.2 s, 30 frames/s)."""
    w, h = BLOB_SIZE
    state = tracker.init_state(h, w, "cpu")
    out = []
    for i, fr in enumerate(blob_clip(max(BLOB_FRAMES) + 1, w, h)):
        state, _ = tracker._update(state, fr, i / 30.0, 20, 0.2)
        if i in BLOB_FRAMES:
            out.append(state.mhi.numpy().copy())
    return out


def case_maps(case: str) -> list[np.ndarray]:
    if case == "blob_clip":
        return blob_mhis()
    return [motion_maps(H, W, seed=7)[case]]


CASES = ["blob_clip", "serpentine", "speckle", "thresh_edge", "frame_edges",
         "uniform", "zeros"]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", CASES)
def test_mirror_equals_propagate(case, tile):
    """The mirror's labels equal ``_propagate``'s on every map, whatever
    the tile and the order of the unions."""
    rng = np.random.RandomState(zlib.crc32(f"{case} {tile}".encode()))
    for mhi in case_maps(case):
        want = tracker._propagate(torch.from_numpy(mhi), SEG_THRESH).numpy()
        got = mirror_labels(mhi, SEG_THRESH, tile, rng)
        assert np.array_equal(got, want)
        # the labelling is not vacuous: components of more than one pixel
        # wherever there is motion
        n_roots = int((want == np.arange(want.size)).sum())
        if (mhi > 0).any():
            assert n_roots < want.size


def test_threshold_edge_links_exactly_at_the_threshold():
    """``thresh_edge`` holds neighbours whose float32 difference is
    exactly float32(0.05) and ones whose difference is the next float:
    ``_propagate`` links the first and not the second, so the left half
    of a band is one component and the right half one-pixel ones."""
    mhi = motion_maps(H, W, seed=7)["thresh_edge"]
    d = np.abs(mhi[:, 1:] - mhi[:, :-1])
    f = np.float32(SEG_THRESH)
    assert (d == f).sum() > 0
    assert (d == np.nextafter(f, np.float32(1.0))).sum() > 0
    lab = tracker._propagate(torch.from_numpy(mhi), SEG_THRESH).numpy()
    lab = lab.reshape(H, W)
    assert (lab[:5, :W // 2] == 0).all()
    right = lab[:5, W // 2 + 1:]
    own = np.arange(H * W).reshape(H, W)[:5, W // 2 + 1:]
    assert (right == own).all()


def test_motion_ccl_takes_cuda_tensors_only():
    """The kernel's wrapper raises for a CPU tensor and for an MHI that
    is not a contiguous [H, W] float32 tensor, before any build."""
    with pytest.raises(ValueError, match="no motion labelling kernel"):
        motion_ccl_cuda.motion_ccl(torch.zeros(4, 4), SEG_THRESH)
    for bad in (torch.zeros(4, 4, dtype=torch.float64),
                torch.zeros(2, 4, 4), torch.zeros(4, 8)[:, ::2],
                torch.zeros(0, 4)):
        with pytest.raises(ValueError):
            motion_ccl_cuda._check(bad)


def test_segment_motion_on_cpu_runs_the_plain_loop():
    """On the CPU ``segment_motion`` labels through ``_propagate`` and
    reports its iterations; ``Tracker.process`` counts them while
    tracing and counts no kernel frame."""
    clip = blob_clip(4, *BLOB_SIZE)
    tr = tracker.Tracker(BLOB_SIZE, device="cpu")
    t = tracing.TRACER
    t.enabled = True
    try:
        t.counters.clear()
        tr.process(clip)
        counters = dict(t.counters)
    finally:
        t.enabled = False
        t.sections.clear()
        t.counters.clear()
    assert counters["vca.tracker.frames"] == 4
    assert counters["vca.tracker.seg_iterations"] > 0
    assert "vca.tracker.ccl_frames" not in counters
