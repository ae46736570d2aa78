"""The survivor stages of tilted cascades on the CPU, through the plain
version of ``ops/cuda/survivor_cuda.survivor_eval`` (the kernel is
``csrc/survivor_eval.cu``), against the evaluation it replaced: each
survivor slot's patch of the sum and tilted tables, cast to float64 and
multiplied by the block's dense feature matrices, then the weak trees'
selects and the stage sums as a matmul with the stage one-hot matrix. The
engine keeps none of those matrices: the test builds them from the
cascade.

On the bundled right-eye, left-eye and smile (mouth) cascades at the part
chain's 320x180, factor 1.1, on equalized synthetic 720p faces: every
level and every block gives the same passed flags, and the engine's
``_level_post`` gives the same boxes, valid slots and overflow flags, at
the engine's capacities and at capacities cut down so that survivors
overflow them and each block re-compacts. The kernel against this plain
version is ``tests/test_torch_cuda.py``'s.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine, load_cascade
from nubomedia_vca_tpu_torch.cascade.paths import PKG_ASSETS_DIR
from nubomedia_vca_tpu_torch.ops.cuda import survivor_cuda
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact
from nubomedia_vca_tpu_torch.utils.synth import face_clip

torch.set_num_threads(2)

SIZE = (320, 180)
CASCADES = {"right": ("haarcascade_righteye_2splits.xml", (20, 20)),
            "left": ("haarcascade_lefteye_2splits.xml", (20, 20)),
            "mouth": ("haarcascade_smile.xml", (1, 1))}


def _engine(part):
    name, min_size = CASCADES[part]
    return CascadeEngine(load_cascade(os.path.join(PKG_ASSETS_DIR, name)),
                         SIZE, 1.1, min_size=min_size, device="cpu")


@pytest.fixture(scope="module")
def work():
    return equalize_hist(resize_linear_exact(
        torch.from_numpy(face_clip(2, 1280, 720, seed=3)), SIZE))


@pytest.fixture(scope="module")
def dense(work):
    """Per cascade, each level's dense phase: ((ii, iit), vnf, alive)."""
    out = {}
    for part in CASCADES:
        eng = _engine(part)
        assert eng.routes == ["tilted"] * len(eng.levels)
        out[part] = [eng._dense_level(work, li)
                     for li in range(len(eng.levels))]
    return out


def _patch_flags(eng, li, ii, iit, vnf, win_ids, alive, bi):
    """The replaced evaluation of block `bi`, its matrices built here from
    the engine's feature rects and the cascade's trees: each slot's patch
    of both tables, cast to float64, times the dense [patch, features]
    matrices of the block's features; tree selects; stage sums by the
    one-hot matmul → alive & passed."""
    c, l = eng.cascade, eng.levels[li]
    pw, ph = c.window_w + 1, c.window_h + 1
    s_lo = eng.n_dense_stages + sum(len(b.stage_thr)
                                    for b in eng._blocks[:bi])
    s_hi = s_lo + len(eng._blocks[bi].stage_thr)
    trees = np.flatnonzero((c.weak_stage >= s_lo) & (c.weak_stage < s_hi))
    used = np.unique(np.concatenate(
        [c.feat0[trees], c.featL[trees], c.featR[trees]]))
    w = {t: np.zeros((ph * pw, len(used)), np.float32)
         for t in ("sum", "tilt")}
    for i, f in enumerate(used):
        for table, corners, wgt in eng._feat_rects[f]:
            for dy, dx, s in corners:
                assert 0 <= dy < ph and 0 <= dx < pw
                w[table][dy * pw + dx, i] += s * wgt
    onehot = np.eye(s_hi - s_lo, dtype=np.float32)[
        c.weak_stage[trees] - s_lo]

    B, k = win_ids.shape
    y, x = (win_ids // l.nx) * l.ystep, (win_ids % l.nx) * l.ystep
    dy, dx = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
    poff = torch.from_numpy((dy * (l.sw + 1) + dx).reshape(-1))
    idx = ((y * (l.sw + 1) + x)[:, :, None] + poff).reshape(B, -1)
    p = ii.reshape(B, -1).gather(1, idx).reshape(B, k, ph, pw)
    p = (p - p[:, :, :1, :] - p[:, :, :, :1] + p[:, :, :1, :1])
    pt = iit.reshape(B, -1).gather(1, idx).reshape(B, k, -1)
    pt = pt - pt[:, :, :1]
    t = lambda a: torch.from_numpy(np.asarray(a))
    feats = (p.reshape(B, k, -1).double() @ t(w["sum"]).double()
             + pt.double() @ t(w["tilt"]).double())
    vals = feats.float() * vnf.reshape(B, -1).gather(1, win_ids)[:, :, None]
    v0, vL, vR = (vals[..., t(np.searchsorted(used, f[trees]))]
                  for f in (c.feat0, c.featL, c.featR))
    lv = torch.where(vL < t(c.thrL[trees]), t(c.leavesL[trees])[:, 0],
                     t(c.leavesL[trees])[:, 1])
    rv = torch.where(vR < t(c.thrR[trees]), t(c.leavesR[trees])[:, 0],
                     t(c.leavesR[trees])[:, 1])
    wout = torch.where(v0 < t(c.thr0[trees]), lv, rv)
    ssums = wout @ t(onehot)
    return alive & (ssums >= t(c.stage_thresholds[s_lo:s_hi])).all(dim=-1)


def _cut_caps(eng):
    """Every level's capacities cut to 12 and 6 slots."""
    eng._level_caps = [[min(c, n) for c, n in zip(caps, (12, 6))]
                       for caps in eng._level_caps]


@pytest.mark.parametrize("cut", ["none", "MAX_CAPACITY", "level_caps"])
@pytest.mark.parametrize("part", sorted(CASCADES))
def test_survivor_stages_equal_patch_matmul(dense, monkeypatch, part, cut):
    """Per level and block: the plain version's flags equal the replaced
    evaluation's on the same compacted slots; ``_level_post`` (boxes,
    valid, overflow) equals compaction with the replaced evaluation. With
    the capacities cut (MAX_CAPACITY 16 a level and block, read when an
    engine is built, or every level's capacities cut to 12 and 6 slots)
    frames overflow, and with 12 and 6 every block re-compacts."""
    if cut == "MAX_CAPACITY":
        monkeypatch.setattr(CascadeEngine, "MAX_CAPACITY", 16)
    eng = _engine(part)
    if cut == "level_caps":
        _cut_caps(eng)
    n_in, n_pass, n_ovf = [0, 0], [0, 0], 0
    for li, ((ii, iit), vnf, alive) in enumerate(dense[part]):
        B = alive.shape[0]
        caps = eng._level_caps[li]
        sel, sel_alive, count = eng._compact(alive.bool().reshape(B, -1),
                                             caps[0])
        overflow = count > caps[0]
        win_ids = sel
        for bi, plan in enumerate(eng._survivor_plans[li]):
            if bi > 0 and caps[bi] < sel_alive.shape[1]:
                sel2, sel_alive, count = eng._compact(sel_alive, caps[bi])
                overflow |= count > caps[bi]
                win_ids = win_ids.gather(1, sel2)
            want = _patch_flags(eng, li, ii, iit, vnf, win_ids, sel_alive,
                                bi)
            got = survivor_cuda.survivor_eval(ii, iit, vnf, win_ids,
                                              sel_alive, plan)
            assert torch.equal(got, want), (li, bi)
            n_in[bi] += int(sel_alive.sum())
            n_pass[bi] += int(got.sum())
            sel_alive = got
        boxes, valid, ovf = eng._level_post(li, (ii, iit), vnf,
                                            alive.bool())
        l, (map_x, map_y) = eng.levels[li], eng._maps[li]
        assert torch.equal(valid, sel_alive), li
        assert torch.equal(ovf, overflow), li
        want = np.stack(np.broadcast_arrays(
            map_x[win_ids % l.nx], map_y[win_ids // l.nx], l.out_w,
            l.out_h), -1)
        assert boxes.dtype == torch.int32, li
        assert np.array_equal(boxes.numpy(), want), li
        n_ovf += int(ovf.sum())
    assert n_in[0] > n_pass[0] > 0 and 0 < n_in[1] <= n_pass[0]
    assert (n_ovf > 0) == (cut != "none" or part == "mouth")
    if cut == "level_caps":
        assert all(caps[1] < caps[0] for caps in eng._level_caps)


def test_tilted_engine_needs_integer_weights():
    """The survivor stages sum features exactly in int32: a tilted cascade
    with a rect weight that is not an integer is refused when the engine is
    built."""
    casc = load_cascade(os.path.join(PKG_ASSETS_DIR,
                                     CASCADES["right"][0]))
    w = casc.rect_weights.copy()
    w[0, 1] = 2.5
    with pytest.raises(ValueError, match="not an integer"):
        CascadeEngine(dataclasses.replace(casc, rect_weights=w), SIZE, 1.1,
                      min_size=(20, 20), device="cpu")


def test_survivor_eval_checks_inputs(dense):
    """The wrapper raises on tables, maps or slots it does not take, and on
    a device with no kernel."""
    eng = _engine("right")
    (ii, iit), vnf, alive = dense["right"][3]
    plan = eng._survivor_plans[3][0]
    B = ii.shape[0]
    win = torch.zeros((B, 8), dtype=torch.int64)
    live = torch.ones((B, 8), dtype=torch.bool)
    assert survivor_cuda.survivor_eval(ii, iit, vnf, win, live,
                                       plan).shape == (B, 8)
    with pytest.raises(ValueError, match="sum table"):
        survivor_cuda.survivor_eval(ii[:, 1:], iit, vnf, win, live, plan)
    with pytest.raises(ValueError, match="tilted table"):
        survivor_cuda.survivor_eval(ii, iit.long(), vnf, win, live, plan)
    with pytest.raises(ValueError, match="vnf"):
        survivor_cuda.survivor_eval(ii, iit, vnf.double(), win, live, plan)
    with pytest.raises(TypeError, match="window ids"):
        survivor_cuda.survivor_eval(ii, iit, vnf, win.int(), live, plan)
    with pytest.raises(ValueError, match="alive"):
        survivor_cuda.survivor_eval(ii, iit, vnf, win, live[:, :4], plan)
    with pytest.raises(ValueError, match="no survivor kernel"):
        survivor_cuda.survivor_eval(ii, iit, vnf, win.to("meta"),
                                    live, plan)
    before = survivor_cuda.survivor_eval.launches
    eng._level_post(3, (ii, iit), vnf, alive.bool())
    assert survivor_cuda.survivor_eval.launches == before
