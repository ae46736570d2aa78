"""The PyTorch port's motion tracker against the JAX package on the CPU, on
the moving-blob clip at 320x240 (``tests/fixtures.py``).

The port segments motion one way, ``segment_motion``: every seeded
component, in the raster order of its first seed pixel. The JAX package's
``tracker_step`` keeps ``max_blobs`` slots, earliest root first;
``_jax_step`` rebuilds that compaction here over the port's own steps
(``_update``, ``_propagate``, ``_boxes``). Per frame its rects and valid
slots are held slot for slot against the JAX step's (past its capacity
too), with the MHI and the previous frame, and ``segment_motion``'s rects
equal the JAX step's valid rects as a set whenever the JAX slots are not
all taken (a superset when they are). Then ``Tracker.process`` against
that frame loop and the JAX ``tracker_scan``, ``Tracker.process`` across
two streams and a ``reconfigure``, a run resumed from a JAX mid-clip state
through ``TrackerState.from_numpy``, and the host blob merge. The JAX
step's motion gradient (mask, orientation) has no counterpart in the port:
no blob depends on it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models import tracker as jax_tracker
from nubomedia_vca_tpu_torch.models import tracker
from nubomedia_vca_tpu_torch.models.tracker import (Tracker, TrackerConfig,
                                                    TrackerState)

from .fixtures import moving_blob_clip

torch.set_num_threads(2)

H, W = 240, 320


def _step_kw(dur=0.2, sth=0.05, max_blobs=32):
    return dict(threshold=20, mhi_duration=dur, seg_thresh=sth,
                max_blobs=max_blobs)


def _jax_step(state, gray, ts, *, threshold, mhi_duration, seg_thresh,
              max_blobs, iterations=None):
    """One frame through the port's steps, compacted as the JAX package's
    ``tracker_step`` compacts → (new state, rects [max_blobs, 4] int32,
    valid [max_blobs]): the seeded components' roots, earliest first;
    empty slots' rects 0; nothing valid on a state's first frame."""
    new, ts = tracker._update(state, gray, ts, threshold, mhi_duration)
    h, w = new.mhi.shape
    n = h * w
    lab = tracker._propagate(new.mhi, seg_thresh, iterations)
    seeds = (new.mhi == ts).reshape(-1).to(torch.int32)
    is_root = ((lab == torch.arange(n))
               & (tracker._reduce(lab, 0, seeds, "amax") > 0))
    keys = torch.where(is_root, torch.arange(n, 0, -1), 0)
    sel = torch.topk(keys, max_blobs).indices
    valid = is_root[sel]
    rects = torch.where(valid[:, None], tracker._boxes(lab, sel, h, w), 0)
    return new, rects, valid & state.initialized


def _assert_step_equal(got, want):
    (st, rects, valid), (jst, jr, jv, _, _) = got, want
    assert np.array_equal(rects.numpy(), np.asarray(jr))    # slot for slot
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(st.mhi.numpy(), np.asarray(jst.mhi))
    assert np.array_equal(st.prev_gray.numpy(), np.asarray(jst.prev_gray))


def _rows(a) -> list[tuple]:
    return sorted(map(tuple, np.asarray(a).tolist()))


def _assert_segment_motion_covers(state, ts, sth, want):
    """``segment_motion``'s rects on the step's state equal the JAX step's
    valid rects as a set, or hold them and more when every JAX slot is
    taken; → whether the JAX slots were all taken."""
    got = tracker.segment_motion(
        state.mhi, torch.as_tensor(ts, dtype=torch.float32), sth).numpy()
    jr, jv = np.asarray(want[1]), np.asarray(want[2])
    if not jv.all():
        assert _rows(got) == _rows(jr[jv])
        return False
    assert set(_rows(jr)) <= set(_rows(got)) and len(got) >= len(jv)
    return True


@pytest.mark.parametrize("nfr,dur,sth", [(8, 0.2, 0.05), (12, 0.2, 0.05),
                                         (8, 0.1, 0.03)])
def test_tracker_step_matches_jax(nfr, dur, sth):
    clip = moving_blob_clip(nfr)
    st, jst = tracker.init_state(H, W, "cpu"), jax_tracker.init_state(H, W)
    n_blobs = []
    for i, fr in enumerate(clip):
        got = _jax_step(st, fr, i / 30.0, **_step_kw(dur, sth))
        want = jax_tracker.tracker_step(jst, fr, i / 30.0,
                                        **_step_kw(dur, sth))
        _assert_step_equal(got, want)
        assert not _assert_segment_motion_covers(got[0], i / 30.0, sth, want)
        st, jst = got[0], want[0]
        n_blobs.append(int(got[2].sum()))
    assert n_blobs[0] == 0 and min(n_blobs[1:]) >= 2


def test_segment_compaction_past_capacity():
    """More seeded roots than max_blobs: the rebuilt compaction keeps the
    earliest roots as the JAX step does, rects and valid slots equal slot
    for slot, and ``segment_motion`` reports every component, the kept
    ones among them."""
    rng = np.random.RandomState(5)
    clip = moving_blob_clip(4)
    speck = rng.rand(4, H, W) < 0.002          # many one-pixel blobs
    clip = np.where(speck, 255, clip).astype(np.uint8)
    st, jst = tracker.init_state(H, W, "cpu"), jax_tracker.init_state(H, W)
    for i, fr in enumerate(clip):
        got = _jax_step(st, fr, i / 30.0, **_step_kw(max_blobs=8))
        want = jax_tracker.tracker_step(jst, fr, i / 30.0,
                                        **_step_kw(max_blobs=8))
        _assert_step_equal(got, want)
        full = _assert_segment_motion_covers(got[0], i / 30.0, 0.05, want)
        st, jst = got[0], want[0]
    assert got[2].all() and full               # capacity full


def test_tracker_scan_matches_step_loop_and_jax():
    """``Tracker.process`` over 8 frames in one call equals the frame loop
    of ``_update``, ``segment_motion`` and ``join_objects`` (its
    iterations counted through ``iterations=``), and its final MHI the
    loop's and the JAX ``tracker_scan``'s; the loop's rebuilt JAX
    compaction equals the scan's rects and valid slots frame for frame."""
    clip = moving_blob_clip(8)
    ts = np.arange(8) / 30.0
    cfg = TrackerConfig()
    tr = Tracker((W, H), cfg, device="cpu")
    out = tr.process(clip)
    st = tracker.init_state(H, W, "cpu")
    iters, want, rects, valid = [], [], [], []
    for i in range(8):
        _, r, v = _jax_step(st, clip[i], ts[i], **_step_kw())
        rects.append(r)
        valid.append(v)
        st, t = tracker._update(st, clip[i], ts[i], cfg.threshold,
                                cfg.mhi_duration)
        want.append(tracker.join_objects(
            tracker.segment_motion(st.mhi, t, cfg.seg_thresh,
                                   iters).numpy(),
            cfg.min_area, cfg.max_area, cfg.distance))
    assert len(iters) == 8 and all(i % tracker.SEG_CHECK_EVERY == 0
                                   for i in iters)
    assert out == want and sum(len(b) for b in out) > 0
    assert torch.equal(tr.state.mhi, st.mhi)
    jfinal, jr, jv = jax_tracker.tracker_scan(
        jax_tracker.init_state(H, W), clip, ts, **_step_kw())
    assert np.array_equal(torch.stack(rects).numpy(), np.asarray(jr))
    assert np.array_equal(torch.stack(valid).numpy(), np.asarray(jv))
    assert np.array_equal(tr.state.mhi.numpy(), np.asarray(jfinal.mhi))


def test_tracker_process_streams_and_reconfigure():
    clip = moving_blob_clip(12)
    mine = Tracker((W, H), device="cpu")
    ref = jax_tracker.Tracker((W, H))
    out = []
    for tr in (mine, ref):
        res = [tr.process(clip[:5]), tr.process(clip[::-1][:4], stream=1),
               tr.process(clip[5:8])]
        cfg = TrackerConfig(min_area=100, distance=60) if tr is mine else \
            jax_tracker.TrackerConfig(min_area=100, distance=60)
        tr.reconfigure(cfg)
        res += [tr.process(clip[8:], stream=0),
                tr.process(clip[::-1][4:8], stream=1)]
        out.append(res)
    assert out[0] == out[1]
    assert out[0][0][0] == []
    assert sum(len(f) for r in out[0] for f in r) > 10
    assert mine.frame_idx == 12 and mine._frame_idx[1] == 8
    assert np.array_equal(mine.state.mhi.numpy(), np.asarray(ref.state.mhi))


def test_resume_from_jax_mid_clip_state():
    """The JAX package's state after 5 frames, carried across: the next 5
    frames give the same blobs and MHI in both packages."""
    clip = moving_blob_clip(10)
    jst = jax_tracker.init_state(H, W)
    for i in range(5):
        jst = jax_tracker.tracker_step(jst, clip[i], i / 30.0,
                                       **_step_kw())[0]
    st = TrackerState.from_numpy(np.asarray(jst.prev_gray),
                                 np.asarray(jst.mhi),
                                 np.asarray(jst.initialized), device="cpu")
    assert bool(st.initialized) and (st.mhi > 0).any()
    for i in range(5, 10):
        got = _jax_step(st, clip[i], i / 30.0, **_step_kw())
        want = jax_tracker.tracker_step(jst, clip[i], i / 30.0, **_step_kw())
        _assert_step_equal(got, want)
        st, jst = got[0], want[0]


@pytest.mark.parametrize("rects,expected", [
    # area filter drops tiny and huge blobs
    ([(0, 0, 5, 5), (10, 10, 20, 20), (100, 100, 200, 200)],
     [(10, 10, 20, 20)]),
    # nearby blobs merge to their union box
    ([(10, 10, 20, 20), (25, 12, 20, 20)], [(10, 10, 35, 22)]),
    # distant blobs stay separate
    ([(10, 10, 20, 20), (200, 200, 20, 20)],
     [(10, 10, 20, 20), (200, 200, 20, 20)]),
])
def test_join_objects_matches_jax(rects, expected):
    got = tracker.join_objects(rects, 50, 30000, 35)
    assert got == expected
    assert got == jax_tracker.join_objects(rects, 50, 30000, 35)
