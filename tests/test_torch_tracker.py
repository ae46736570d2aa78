"""The PyTorch port's motion tracker against the JAX package on the CPU, on
the moving-blob clip at 320x240 (``tests/fixtures.py``).

Per frame of ``tracker_step``: blob rects and valid slot for slot (the
earliest-root ``top_k`` compaction included, also past its capacity), the
MHI and the motion-gradient mask are equal; the orientation is held within
ORIENT_ATOL degrees on the mask, since ``atan2`` is not correctly rounded
on any backend (no box depends on it: ``Tracker.process`` discards it).
Then ``tracker_scan`` against the step loop, ``Tracker.process`` across two
streams and a ``reconfigure``, a run resumed from a JAX mid-clip state
through ``TrackerState.from_numpy``, and the host blob merge.
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

ORIENT_ATOL = 1e-3     # degrees
H, W = 240, 320


def _step_kw(dur=0.2, sth=0.05, max_blobs=32):
    return dict(threshold=20, mhi_duration=dur, seg_thresh=sth,
                max_blobs=max_blobs)


def _assert_step_equal(got, want):
    (st, rects, valid, mask, orient), (jst, jr, jv, jm, jo) = got, want
    assert np.array_equal(rects.numpy(), np.asarray(jr))    # slot for slot
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(st.mhi.numpy(), np.asarray(jst.mhi))
    assert np.array_equal(st.prev_gray.numpy(), np.asarray(jst.prev_gray))
    assert np.array_equal(mask.numpy(), np.asarray(jm))
    m = mask.numpy()
    err = np.abs(orient.numpy() - np.asarray(jo))[m]
    assert err.size == 0 or err.max() <= ORIENT_ATOL


@pytest.mark.parametrize("nfr,dur,sth", [(8, 0.2, 0.05), (12, 0.2, 0.05),
                                         (8, 0.1, 0.03)])
def test_tracker_step_matches_jax(nfr, dur, sth):
    clip = moving_blob_clip(nfr)
    st, jst = tracker.init_state(H, W, "cpu"), jax_tracker.init_state(H, W)
    n_blobs = []
    for i, fr in enumerate(clip):
        got = tracker.tracker_step(st, fr, i / 30.0, **_step_kw(dur, sth))
        want = jax_tracker.tracker_step(jst, fr, i / 30.0,
                                        **_step_kw(dur, sth))
        _assert_step_equal(got, want)
        st, jst = got[0], want[0]
        n_blobs.append(int(got[2].sum()))
        assert got[3].any() or i < 2
    assert n_blobs[0] == 0 and min(n_blobs[1:]) >= 2


def test_segment_compaction_past_capacity():
    """More seeded roots than max_blobs: both keep the earliest roots, and
    the rects and valid slots are equal slot for slot."""
    rng = np.random.RandomState(5)
    clip = moving_blob_clip(4)
    speck = rng.rand(4, H, W) < 0.002          # many one-pixel blobs
    clip = np.where(speck, 255, clip).astype(np.uint8)
    st, jst = tracker.init_state(H, W, "cpu"), jax_tracker.init_state(H, W)
    for i, fr in enumerate(clip):
        got = tracker.tracker_step(st, fr, i / 30.0, **_step_kw(max_blobs=8))
        want = jax_tracker.tracker_step(jst, fr, i / 30.0,
                                        **_step_kw(max_blobs=8))
        _assert_step_equal(got, want)
        st, jst = got[0], want[0]
    assert got[2].all()                        # capacity full


def test_tracker_scan_matches_step_loop_and_jax():
    clip = moving_blob_clip(8)
    ts = np.arange(8) / 30.0
    iters = []
    final, rects, valid = tracker.tracker_scan(
        tracker.init_state(H, W, "cpu"), clip, ts, iterations=iters,
        **_step_kw())
    assert len(iters) == 8 and all(i % tracker.SEG_CHECK_EVERY == 0
                                   for i in iters)
    st = tracker.init_state(H, W, "cpu")
    for i in range(8):
        st, r, v, _, _ = tracker.tracker_step(st, clip[i], ts[i],
                                              **_step_kw())
        assert torch.equal(rects[i], r) and torch.equal(valid[i], v)
    assert torch.equal(final.mhi, st.mhi)
    jfinal, jr, jv = jax_tracker.tracker_scan(
        jax_tracker.init_state(H, W), clip, ts, **_step_kw())
    assert np.array_equal(rects.numpy(), np.asarray(jr))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(final.mhi.numpy(), np.asarray(jfinal.mhi))


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
        got = tracker.tracker_step(st, clip[i], i / 30.0, **_step_kw())
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
