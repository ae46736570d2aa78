"""The level kernels of the PyTorch port on the CPU, through their plain
versions, against the JAX package's Pallas kernels in interpret mode:

* ``integral_cuda.integral_tables`` (``csrc/integral_tables.cu``) against
  ``integral_images_pallas``;
* ``dense_level_cuda`` in its tilted form (``csrc/dense_level.cu``, the
  single-block kernel with the tilted table) against ``build_dense_phase``
  on a tilted cascade, as ``tests/test_pallas_ops.py`` checks the Pallas
  kernel;
* ``dense_level_cuda`` in its row-strip form against the Pallas strip
  kernel (forced to several strips through the JAX engine instance's
  ``PALLAS_DENSE_MAX_ELEMS``) and against a whole-level evaluation;
* a numpy mirror of ``csrc/dense_level.cu`` (strip-local uint32 tables, the
  diagonal build of the tilted table, the packed feature records) against
  the plain version: the layout the CUDA kernel reads, which only a GPU can
  run;
* the engine's per-level routing at the part chain's 720p geometry.

The CUDA kernels themselves are held to their plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.cascade.engine import CascadeEngine as JaxEngine
from nubomedia_vca_tpu.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu.ops.pallas.dense_pallas import build_dense_phase
from nubomedia_vca_tpu.ops.pallas.integral_pallas import (
    integral_images_pallas)
from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine
from nubomedia_vca_tpu_torch.cascade.paths import PKG_ASSETS_DIR
from nubomedia_vca_tpu_torch.cascade.pyramid import LevelSpec
from nubomedia_vca_tpu_torch.cascade.xml_loader import (cascade_from_numpy,
                                                        load_cascade_xml as
                                                        port_load)
from nubomedia_vca_tpu_torch.ops.cuda import dense_level_cuda, integral_cuda
from nubomedia_vca_tpu_torch.ops.cuda.dense_cuda import MAX_SMEM_BYTES
from nubomedia_vca_tpu_torch.ops.cuda.dense_level_cuda import (
    DenseLevelPlan, dense_level_reference)
from nubomedia_vca_tpu_torch.ops.integral import (integral_image,
                                                  sq_integral_image)
from nubomedia_vca_tpu_torch.utils.synth import face_scene

torch.set_num_threads(2)

OPENCV_DIR = "/usr/share/opencv4/haarcascades"


def _u8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def _truncated(casc, n_stages):
    keep = casc.weak_stage < n_stages
    return dataclasses.replace(
        casc, feat0=casc.feat0[keep], thr0=casc.thr0[keep],
        featL=casc.featL[keep], thrL=casc.thrL[keep],
        leavesL=casc.leavesL[keep], featR=casc.featR[keep],
        thrR=casc.thrR[keep], leavesR=casc.leavesR[keep],
        weak_stage=casc.weak_stage[keep],
        stage_thresholds=casc.stage_thresholds[:n_stages])


def _level(sw, sh, step, win=(20, 20)):
    """A LevelSpec of a pre-resized level (factor 1: boxes unused)."""
    gx, gy = sw - win[0] + 1, sh - win[1] + 1
    return LevelSpec(1.0, sw, sh, step, -(-gx // step), -(-gy // step),
                     win[0], win[1])


def _check_vnf(img, l, tabs, vnf, w_vnf):
    """vnf equals, bit for bit, the unfused float32 formula in numpy, and
    lies within the per-window bound of XLA:CPU's fused nf (see
    tests/test_torch_dense_kernel.py); invalid windows are exactly 1."""
    x = img.astype(np.int64)
    ii = np.pad(x.cumsum(-1).cumsum(-2), ((0, 0), (1, 0), (1, 0)))
    sq = np.pad((x * x).cumsum(-1).cumsum(-2), ((0, 0), (1, 0), (1, 0)))
    oy = (np.arange(l.ny) * l.ystep)[:, None]
    ox = (np.arange(l.nx) * l.ystep)[None, :]
    x1, y1 = 1 + tabs.norm_w, 1 + tabs.norm_h

    def win(t):
        return (t[:, oy + 1, ox + 1] - t[:, oy + 1, ox + x1]
                - t[:, oy + y1, ox + 1] + t[:, oy + y1, ox + x1])

    vf = win(ii).astype(np.float32)
    a = np.float32(tabs.norm_area) * win(sq).astype(np.float32)
    p = vf * vf
    nf = a - p
    valid = nf > np.float32(tabs.var_thr)
    unfused = np.where(
        valid, np.float32(1) / np.sqrt(np.maximum(nf, np.float32(1e-20))),
        np.float32(1))
    assert np.array_equal(vnf, unfused)
    assert np.array_equal(vnf[~valid], w_vnf[~valid])
    a, p, nf = a[valid], p[valid], nf[valid]
    tol = ((np.spacing(a) + np.spacing(p)) / (2.0 * nf)
           + 4 * np.finfo(np.float32).eps)
    rel = np.abs(vnf[valid].astype(np.float64) - w_vnf[valid]) / w_vnf[valid]
    assert (rel <= tol).all(), float((rel / tol).max())


# ------------------------------------------------------------------ #4
@pytest.mark.parametrize("shape", [(2, 37, 53), (2, 112, 199)])
def test_integral_tables_plain_matches_pallas(shape):
    """The plain version of the integral-tables kernel equals the Pallas
    kernel in interpret mode (112x199: the smallest level that takes the
    kernel at 720p); the CPU wrapper runs it and launches nothing."""
    img = _u8(sum(shape), shape)
    want = integral_images_pallas(jnp.asarray(img), interpret=True)
    before = integral_cuda.integral_tables.launches
    got = integral_cuda.integral_tables(torch.from_numpy(img))
    assert integral_cuda.integral_tables.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_integral_tables_checks_inputs():
    with pytest.raises(TypeError):
        integral_cuda.integral_tables(torch.zeros((2, 8, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        integral_cuda.integral_tables(torch.zeros((8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        integral_cuda.integral_tables(
            torch.zeros((2, 8, 9), dtype=torch.uint8).transpose(1, 2))


# ------------------------------------------------------------------ #2
@pytest.fixture(scope="module")
def tilted_engines():
    """The left eye's first 3 stages (all in the dense block, with tilted
    features) at 48x40, as the JAX package's own tilted-kernel test."""
    casc = _truncated(load_cascade_xml(
        os.path.join(OPENCV_DIR, "haarcascade_lefteye_2splits.xml")), 3)
    jeng = JaxEngine(casc, (48, 40), 1.25, use_pallas_dense=True)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)),
                         (48, 40), 1.25, device="cpu")
    assert jeng._dense_uses_tilt and peng._tables.tilted
    assert peng.n_dense_stages == jeng.n_dense_stages == 3
    return jeng, peng


def test_tilted_plain_matches_pallas(tilted_engines):
    """ii and iit exact, vnf exact to the unfused formula and within the
    XLA:CPU bound, alive exact and non-empty, on every level of noise."""
    jeng, peng = tilted_engines
    assert peng.routes == ["tilted"] * len(peng.levels)
    n_alive = 0
    for li, l in enumerate(peng.levels):
        img = _u8(li + 7, (2, l.sh, l.sw))
        ii, iit, vnf, alive = dense_level_reference(
            torch.from_numpy(img), peng._level_plans[li])
        w_ii, w_iit, w_vnf, w_alive = build_dense_phase(
            jeng, l.sh, l.sw, l.ystep)(jnp.asarray(img), interpret=True)
        assert np.array_equal(ii.numpy(), np.asarray(w_ii))
        assert np.array_equal(iit.numpy(), np.asarray(w_iit))
        assert np.array_equal(alive.numpy(),
                              np.asarray(w_alive).astype(np.uint8))
        _check_vnf(img, l, peng._tables, vnf.numpy(), np.asarray(w_vnf))
        n_alive += int(alive.sum())
    assert n_alive > 0


def test_tilted_wrapper_on_cpu_runs_plain_version(tilted_engines):
    _, peng = tilted_engines
    plan = peng._level_plans[0]
    x = torch.from_numpy(_u8(3, (2, plan.level.sh, plan.level.sw)))
    before = dense_level_cuda.dense_level_tilted.launches
    got = dense_level_cuda.dense_level_tilted(x, plan)
    assert dense_level_cuda.dense_level_tilted.launches == before
    for g, w in zip(got, dense_level_reference(x, plan)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="tilted"):
        dense_level_cuda.dense_level_strips(x, plan)
    with pytest.raises(ValueError):
        dense_level_cuda.dense_level_tilted(x[:, 1:], plan)
    with pytest.raises(TypeError):
        dense_level_cuda.dense_level_tilted(x.to(torch.int32), plan)


# ------------------------------------------------------------------ #3
@pytest.fixture(scope="module")
def strip_case():
    """The face cascade's dense block on a tall 60x150 level (ystep 2) of
    faces and noise."""
    casc = load_cascade_xml(
        os.path.join(OPENCV_DIR, "haarcascade_frontalface_alt.xml"))
    jeng = JaxEngine(casc, (60, 150), 1.25, use_pallas_dense=True)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)),
                         (60, 150), 1.25, device="cpu")
    l = _level(60, 150, 2)
    faces = np.stack([face_scene(60, 150, faces=((30, 40, 22), (30, 110, 26)),
                                 seed=s) for s in range(2)])
    img = np.concatenate([faces, _u8(5, (1, 150, 60))])
    return jeng, peng, l, img


def test_strip_plain_matches_pallas_strips(strip_case):
    """Three strips (the last ragged) on both sides: the Pallas strip
    kernel (forced through PALLAS_DENSE_MAX_ELEMS on the JAX engine
    instance) and the port's plain version, whose strips the budget below
    forces; alive exact and non-empty, vnf exact to the unfused formula and
    within the XLA:CPU bound, and equal to the whole-level evaluation."""
    jeng, peng, l, img = strip_case
    jeng.PALLAS_DENSE_MAX_ELEMS = 61 * 84     # strip_gy 64: 3 strips
    w_ii, w_iit, w_vnf, w_alive = build_dense_phase(
        jeng, l.sh, l.sw, l.ystep)(jnp.asarray(img), interpret=True)
    assert w_ii is None and w_iit is None
    plan = DenseLevelPlan.make(l, peng._tables, tilted=False,
                               max_smem=8 * 61 * 65)
    assert (plan.strip_gy, plan.n_strips) == (44, 3)   # 131 = 44+44+43 rows
    ii, iit, vnf, alive = dense_level_reference(torch.from_numpy(img), plan)
    assert ii is None and iit is None
    assert np.array_equal(alive.numpy(), np.asarray(w_alive).astype(np.uint8))
    assert alive.sum() > 0
    _check_vnf(img, l, peng._tables, vnf.numpy(), np.asarray(w_vnf))

    x = torch.from_numpy(img)
    whole = peng._tables.evaluate(integral_image(x), sq_integral_image(x),
                                  None, l.ny, l.nx, l.ystep)
    assert torch.equal(vnf, whole[0]) and torch.equal(alive, whole[1])


@pytest.mark.parametrize("max_smem,n_strips", [(MAX_SMEM_BYTES, 1),
                                               (8 * 61 * 43, 6),
                                               (8 * 61 * 22, 66)])
def test_strip_count_does_not_change_result(strip_case, max_smem, n_strips):
    """Any strip geometry gives the whole-level result: one strip (the
    non-tilted single block), six, and one strided window row per strip."""
    _, peng, l, img = strip_case
    plan = DenseLevelPlan.make(l, peng._tables, tilted=False,
                               max_smem=max_smem)
    assert plan.n_strips == n_strips
    x = torch.from_numpy(img)
    before = dense_level_cuda.dense_level_strips.launches
    vnf, alive = dense_level_cuda.dense_level_strips(x, plan)
    assert dense_level_cuda.dense_level_strips.launches == before
    whole = peng._tables.evaluate(integral_image(x), sq_integral_image(x),
                                  None, l.ny, l.nx, l.ystep)
    assert torch.equal(vnf, whole[0]) and torch.equal(alive, whole[1])


# ------------------------------------------------------ kernel mirror
def _level_kernel_mirror(plan, img):
    """numpy mirror of csrc/dense_level.cu: per (strip, frame) block,
    uint32 strip-local tables, the tilted table by the diagonal running
    sums (tilted form), then the window loop over the packed feature and
    weak-tree records (float32 throughout)."""
    t, tabs, l = plan.tables.host, plan.tables, plan.level
    f32, u32 = np.float32, np.uint32
    h0 = tabs.window_h
    B = img.shape[0]
    vnf_out = np.zeros((B, l.ny, l.nx), f32)
    alive_out = np.zeros((B, l.ny, l.nx), np.uint8)
    ii_out = iit_out = None
    for s in range(plan.n_strips):
        row0 = s * plan.strip_gy
        rows = min(plan.strip_gy + h0 - 1, l.sh - row0)
        x = img[:, row0:row0 + rows].astype(np.int64)
        ii = np.zeros((B, rows + 1, l.sw + 1), u32)
        sq = np.zeros((B, rows + 1, l.sw + 1), u32)
        ii[:, 1:, 1:] = x.cumsum(-1).cumsum(-2)
        sq[:, 1:, 1:] = (x * x).cumsum(-1).cumsum(-2)
        iit = np.zeros_like(ii)
        if plan.tilted:
            sw = l.sw
            for d in range(sw + rows + 1):          # anti-diagonals: A
                y = max(0, d - sw)
                xx = d - y
                a = np.zeros(B, u32) if y == 0 else ii[:, y, sw].copy()
                iit[:, y, xx] = a
                while y < rows and xx > 0:
                    a += ii[:, y + 1, xx - 1] - ii[:, y, xx - 1]
                    y, xx = y + 1, xx - 1
                    iit[:, y, xx] = a
            for d in range(sw + rows + 1):          # diagonals: minus D
                y = max(0, rows - d)
                xx = d - rows + y
                dsum = np.zeros(B, u32)
                while y < rows and xx < sw:
                    dsum += ii[:, y + 1, xx] - ii[:, y, xx]
                    y, xx = y + 1, xx + 1
                    iit[:, y, xx] -= dsum
            ii_out, iit_out = ii.view(np.int32), iit.view(np.int32)
        iy0 = row0 // l.ystep
        iy1 = min(l.ny, (row0 + plan.strip_gy) // l.ystep)
        oy = (np.arange(iy0, iy1) * l.ystep - row0)[:, None]
        ox = (np.arange(l.nx) * l.ystep)[None, :]

        def at(tab, dy, dx):
            return tab[:, oy + dy, ox + dx]

        def feature(fid):
            fi, fw = t["feat_i"][fid], t["feat_w"][fid]
            val = None
            for r in range(fi[0]):
                rx, ry, rw, rh = fi[1 + 4 * r:5 + 4 * r]
                if fi[-1]:
                    v = (at(iit, ry, rx) - at(iit, ry + rw, rx + rw)
                         - at(iit, ry + rh, rx - rh)
                         + at(iit, ry + rw + rh, rx + rw - rh))
                else:
                    v = (at(ii, ry, rx) - at(ii, ry, rx + rw)
                         - at(ii, ry + rh, rx) + at(ii, ry + rh, rx + rw))
                term = v.view(np.int32).astype(f32) * fw[r]
                val = term if val is None else val + term
            return val

        nw, nh = tabs.norm_w, tabs.norm_h

        def norm_rect(tab):
            return (at(tab, 1, 1) - at(tab, 1, 1 + nw) - at(tab, 1 + nh, 1)
                    + at(tab, 1 + nh, 1 + nw))

        vf = norm_rect(ii).view(np.int32).astype(f32)
        nf = f32(tabs.norm_area) * norm_rect(sq).astype(f32) - vf * vf
        alive = nf > f32(tabs.var_thr)
        vnf = np.where(alive, f32(1) / np.sqrt(np.maximum(nf, f32(1e-20))),
                       f32(1))
        for st in range(tabs.n_dense):
            ssum = np.zeros_like(vnf)
            for k in np.nonzero(t["weak_i"][:, 3] == st)[0]:
                (fa, fl, fr, _), wf = t["weak_i"][k], t["weak_f"][k]
                v0, vl, vr = (feature(f) * vnf for f in (fa, fl, fr))
                lv = np.where(vl < wf[1], wf[3], wf[4])
                rv = np.where(vr < wf[2], wf[5], wf[6])
                ssum = ssum + np.where(v0 < wf[0], lv, rv)
            alive &= ssum >= t["stage_thr"][st]
        vnf_out[:, iy0:iy1] = vnf
        alive_out[:, iy0:iy1] = alive
    return ii_out, iit_out, vnf_out, alive_out


def test_level_kernel_tables_reproduce_plain_version(tilted_engines,
                                                     strip_case):
    """Both forms of the level kernel, mirrored in numpy from the packed
    records: the tilted form on the tilted cascade's largest level, the
    strip form with three strips."""
    _, peng_t = tilted_engines
    _, peng_s, l, img = strip_case
    cases = [(peng_t._level_plans[0],
              _u8(21, (2, peng_t.levels[0].sh, peng_t.levels[0].sw))),
             (DenseLevelPlan.make(l, peng_s._tables, tilted=False,
                                  max_smem=8 * 61 * 65), img)]
    for plan, x in cases:
        got = _level_kernel_mirror(plan, x)
        want = dense_level_reference(torch.from_numpy(x), plan)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert np.array_equal(g, w.numpy())
        assert want[3].sum() > 0


# ------------------------------------------------------------- routing
def test_routing_at_720p():
    """The route of every level of the part chain's engines at 1280x720
    (host geometry only): the face pass at 160x90 all in the pyramid
    kernel; the nose at 320x180: the four levels over the pyramid kernel's
    shared memory in row strips, 20 in one pyramid launch; the mouth and
    eyes: tilted levels up to 181x102 (12 B per table element) in the
    tilted kernel, the six larger ones through the integral kernel."""
    def eng(name, size, factor, min_size):
        return CascadeEngine(port_load(os.path.join(PKG_ASSETS_DIR, name)),
                             size, factor, min_size=min_size, device="cpu")

    face = eng("haarcascade_frontalface_alt.xml", (160, 90), 1.25, (3, 3))
    assert face.routes == ["pyramid"] * 7
    nose = eng("vca_nose_synthetic.xml", (320, 180), 1.1, (1, 1))
    assert nose.routes == ["strips"] * 4 + ["pyramid"] * 20
    assert [(l.sw, l.sh) for l in nose.levels[3:5]] == [(240, 135),
                                                        (219, 123)]
    assert [(p.strip_gy, p.n_strips) for p in nose._level_plans.values()] \
        == [(70, 3), (78, 2), (88, 2), (100, 2)]
    assert all(p.smem_bytes <= MAX_SMEM_BYTES
               for p in nose._level_plans.values())
    assert nose._plan.smem_bytes == 8 * 220 * 124 <= MAX_SMEM_BYTES
    for name, min_size, n_tilted in [
            ("haarcascade_smile.xml", (1, 1), 17),
            ("haarcascade_righteye_2splits.xml", (20, 20), 18),
            ("haarcascade_lefteye_2splits.xml", (20, 20), 18)]:
        e = eng(name, (320, 180), 1.1, min_size)
        assert e.routes == ["tables"] * 6 + ["tilted"] * n_tilted, name
        assert (e.levels[5].sw, e.levels[5].sh) == (199, 112)
        assert (e.levels[6].sw, e.levels[6].sh) == (181, 102)
        assert e._level_plans[6].smem_bytes == 12 * 182 * 103
        assert e._plan is None and e._patch_dtype == torch.float64


def test_level_too_wide_raises():
    """A non-tilted level too wide for even a one-row strip has no route:
    construction raises and names what is missing."""
    casc = port_load(os.path.join(PKG_ASSETS_DIR,
                                  "haarcascade_frontalface_alt.xml"))
    with pytest.raises(NotImplementedError, match="no dense kernel"):
        CascadeEngine(casc, (16000, 40), 1.25, device="cpu")

