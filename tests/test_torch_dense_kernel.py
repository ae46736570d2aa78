"""The pyramid dense phase of the PyTorch port on the CPU.

* The plain PyTorch version (``pyramid_dense_phase_reference``) against the
  JAX package's Pallas kernel ``build_pyramid_dense_phase``, run in interpret
  mode over the full 160x90 chunk of the main path (every level).
* The kernel's host tables, read the way ``csrc/pyramid_dense.cu`` reads
  them, by a numpy mirror of the kernel's arithmetic: checks the table
  layout the CUDA kernel gets, which only a GPU can run.
* The wrapper: CPU tensors take the plain version and launch nothing; bad
  inputs raise; the plan cuts a level too large for one block into bands
  that fit (down to one grid row), and takes every level of a 320-px work
  image, the levels the row-strip kernel took before included.

The CUDA kernel itself is compared with the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.cascade.engine import CascadeEngine as JaxEngine
from nubomedia_vca_tpu.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu.ops.pallas.dense_pallas import (
    build_pyramid_dense_phase)
from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine
from nubomedia_vca_tpu_torch.cascade.xml_loader import cascade_from_numpy
from nubomedia_vca_tpu_torch.models import NoseDetector
from nubomedia_vca_tpu_torch.ops.cuda import _build, dense_cuda
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact
from nubomedia_vca_tpu_torch.utils.synth import face_clip

torch.set_num_threads(2)

FACE_XML = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt.xml"
WORK = (160, 90)     # 1280x720 at the 160-px working width


@pytest.fixture(scope="module")
def engines():
    casc = load_cascade_xml(FACE_XML)
    jeng = JaxEngine(casc, WORK, 1.25, use_pallas_dense=True,
                     use_pallas_pyramid=True)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)), WORK,
                         1.25, device="cpu")
    return jeng, peng


@pytest.fixture(scope="module")
def work():
    """[2, 90, 160] uint8: an equalized 720p face frame and noise."""
    face = equalize_hist(resize_linear_exact(
        torch.from_numpy(face_clip(1, 1280, 720)), WORK))
    noise = np.random.RandomState(9).randint(0, 256, (1, 90, 160), np.uint8)
    return np.concatenate([face.numpy(), noise])


def _norm_terms(img, l, tabs):
    """float32 area*sqsum and sum^2 of every strided window of level image
    img [B,sh,sw] (the two products the variance normalization subtracts)."""
    x = img.astype(np.int64)
    ii = np.pad(x.cumsum(-1).cumsum(-2), ((0, 0), (1, 0), (1, 0)))
    sq = np.pad((x * x).cumsum(-1).cumsum(-2), ((0, 0), (1, 0), (1, 0)))
    oy = (np.arange(l.ny) * l.ystep)[:, None]
    ox = (np.arange(l.nx) * l.ystep)[None, :]

    x1, y1 = 1 + tabs.norm_w, 1 + tabs.norm_h

    def win(t):   # the normalization rect at (1, 1)
        return (t[:, oy + 1, ox + 1] - t[:, oy + 1, ox + x1]
                - t[:, oy + y1, ox + 1] + t[:, oy + y1, ox + x1])

    vf = win(ii).astype(np.float32)
    return np.float32(tabs.norm_area) * win(sq).astype(np.float32), vf * vf


def test_plain_version_matches_pallas_kernel(engines, work):
    """Level images and alive of every level equal the Pallas kernel's
    (interpret mode) exactly.

    vnf: the port's equals, bit for bit, the unfused formula the JAX source
    is written in, computed here in numpy from the window sums: float32
    a = area*sqsum and p = sum^2 each rounded, nf = a - p, IEEE sqrt, IEEE
    reciprocal, and 1.0 for invalid windows.

    Against XLA:CPU's output vnf is bounded per window instead: XLA fuses
    nf = a - p into one FMA and lowers 1/sqrt to an rsqrt within 1 ulp. nf
    is a difference of two close numbers, so that one rounding moves nf by
    up to half an ulp of each product and vnf by up to about 20 ulp
    (measured at 160x90). The bound checked is
    (ulp(a) + ulp(p)) / (2 nf) + 4 eps relative, twice that error analysis;
    invalid windows (vnf = 1.0) and alive stay exact."""
    jeng, peng = engines
    chunk = tuple(range(len(jeng.levels)))
    assert jeng._pyramid_chunks() == (chunk,)      # one chunk, all levels
    want = build_pyramid_dense_phase(jeng, chunk)(jnp.asarray(work),
                                                  interpret=True)
    got = dense_cuda.pyramid_dense_phase_reference(
        torch.from_numpy(work), peng._plan)
    assert len(got) == len(chunk) == 7
    n_alive = n_inexact = 0
    for li, (img_l, vnf, alive) in enumerate(got):
        w_img, w_vnf, w_alive = want[li]
        assert (img_l is None) == (w_img is None), li
        if img_l is not None:
            assert np.array_equal(img_l.numpy(), np.asarray(w_img)), li
        assert np.array_equal(alive.numpy(),
                              np.asarray(w_alive).astype(np.uint8)), li
        n_alive += int(alive.sum())

        vnf, w_vnf = vnf.numpy(), np.asarray(w_vnf)
        a, p = _norm_terms(work if img_l is None else img_l.numpy(),
                           peng.levels[li], peng._tables)
        nf = a - p
        valid = nf > np.float32(peng._tables.var_thr)
        unfused = np.where(
            valid, np.float32(1) / np.sqrt(np.maximum(nf, np.float32(1e-20))),
            np.float32(1))
        assert unfused.dtype == np.float32
        assert np.array_equal(vnf, unfused), li
        assert np.array_equal(vnf[~valid], w_vnf[~valid]), li
        assert (vnf[~valid] == 1.0).all()
        a, p, nf = a[valid], p[valid], nf[valid]
        tol = ((np.spacing(a) + np.spacing(p)) / (2.0 * nf)
               + 4 * np.finfo(np.float32).eps)
        rel = np.abs(vnf[valid].astype(np.float64) - w_vnf[valid]) / w_vnf[valid]
        assert (rel <= tol).all(), (li, float((rel / tol).max()))
        n_inexact += int((vnf != w_vnf).sum())
    assert n_alive > 0
    assert n_inexact > 0    # the FMA really is there; drop the bound if not


def _kernel_mirror(plan, work):
    """numpy mirror of the pyramid kernel's level records and resize
    tables, over whole levels: per level, the 2-tap resize from the packed
    index/coefficient tables, uint32 integral tables, and the window loop
    over the strided grid with the cascade's feature and weak-tree tables
    (float32 throughout). The band geometry and the tree records are
    mirrored by _band_mirror."""
    t = {**plan._host, **plan.tables.host}
    tabs = plan.tables
    f32 = np.float32
    B, H, W = work.shape
    out = []
    for rec in t["levels"]:
        sw, sh, step, nx, ny, same, _, _, rxo, ryo, _ = (int(v) for v in rec)
        if same:
            img = work.astype(np.int64)
        else:
            rx = t["rtab"][rxo:rxo + 4 * sw].reshape(4, sw).astype(np.int64)
            ry = t["rtab"][ryo:ryo + 4 * sh].reshape(4, sh).astype(np.int64)
            src = work.astype(np.int64)
            h = src[:, :, rx[0]] * rx[2] + src[:, :, rx[1]] * rx[3]
            v = (h[:, ry[0], :] * ry[2][:, None]
                 + h[:, ry[1], :] * ry[3][:, None])
            img = np.clip((v + (1 << 15)) >> 16, 0, 255)
        ii = np.zeros((B, sh + 1, sw + 1), np.uint32)
        sq = np.zeros((B, sh + 1, sw + 1), np.uint32)
        ii[:, 1:, 1:] = img.cumsum(-1).cumsum(-2)
        sq[:, 1:, 1:] = (img * img).cumsum(-1).cumsum(-2)
        oy = (np.arange(ny) * step)[:, None]
        ox = (np.arange(nx) * step)[None, :]

        def rect(tab, x, y, w, hh):
            def at(dy, dx):
                return tab[:, oy + dy, ox + dx]
            return at(y, x) - at(y, x + w) - at(y + hh, x) + at(y + hh, x + w)

        def feature(fid):
            fi, fw = t["feat_i"][fid], t["feat_w"][fid]
            assert fi[-1] == 0            # no tilted feature
            val = None
            for r in range(fi[0]):
                x, y, w, hh = fi[1 + 4 * r:5 + 4 * r]
                term = rect(ii, x, y, w, hh).view(np.int32).astype(f32) * fw[r]
                val = term if val is None else val + term
            return val

        vf = rect(ii, 1, 1, tabs.norm_w, tabs.norm_h).view(np.int32).astype(f32)
        sqf = rect(sq, 1, 1, tabs.norm_w, tabs.norm_h).astype(f32)
        nf = f32(tabs.norm_area) * sqf - vf * vf
        alive = nf > f32(tabs.var_thr)
        vnf = np.where(alive, f32(1) / np.sqrt(np.maximum(nf, f32(1e-20))),
                       f32(1))
        for s in range(tabs.n_dense):
            ssum = np.zeros_like(vnf)
            for k in np.nonzero(t["weak_i"][:, 3] == s)[0]:
                (f0, fl, fr, _), wf = t["weak_i"][k], t["weak_f"][k]
                v0, vl, vr = (feature(f) * vnf for f in (f0, fl, fr))
                lv = np.where(vl < wf[1], wf[3], wf[4])
                rv = np.where(vr < wf[2], wf[5], wf[6])
                ssum = ssum + np.where(v0 < wf[0], lv, rv)
            alive &= ssum >= t["stage_thr"][s]
        out.append((None if same else img.astype(np.uint8), vnf,
                    alive.astype(np.uint8)))
    return out


def test_kernel_tables_reproduce_plain_version(engines, work):
    _, peng = engines
    plan = peng._plan
    got = _kernel_mirror(plan, work)
    want = dense_cuda.pyramid_dense_phase_reference(torch.from_numpy(work),
                                                    plan)
    assert [(o[0] is None) for o in got] == [(o[0] is None) for o in want]
    for (gi, gv, ga), (wi, wv, wa) in zip(got, want):
        if gi is not None:
            assert np.array_equal(gi, wi.numpy())
        assert np.array_equal(gv, wv.numpy())
        assert np.array_equal(ga, wa.numpy())


def _records_eval(recs, tabs, ii, sq, origin, pitch):
    """The record evaluator (dense_eval.cuh, eval_records) on flat uint32
    tables [B, rows * pitch] at flat window origins: corner offsets from
    the tree records, float32 throughout."""
    f32 = np.float32

    def feature(f):
        assert f[1] == 0                  # no tilted feature
        val = None
        for r in range(f[0]):
            o = f[2 + 4 * r:6 + 4 * r]
            s = (ii[:, origin + o[0]] - ii[:, origin + o[1]]
                 - ii[:, origin + o[2]] + ii[:, origin + o[3]])
            term = s.view(np.int32).astype(f32) * f[14 + r:15 + r].view(f32)
            val = term if val is None else val + term
        return val

    n0, n2 = pitch + 1, (1 + tabs.norm_h) * pitch + 1

    def norm_rect(t):
        return (t[:, origin + n0] - t[:, origin + n0 + tabs.norm_w]
                - t[:, origin + n2] + t[:, origin + n2 + tabs.norm_w])

    vf = norm_rect(ii).view(np.int32).astype(f32)
    nf = f32(tabs.norm_area) * norm_rect(sq).astype(f32) - vf * vf
    alive = nf > f32(tabs.var_thr)
    vnf = np.where(alive, f32(1) / np.sqrt(np.maximum(nf, f32(1e-20))),
                   f32(1))
    fw = dense_cuda.FEAT_WORDS
    for st in range(tabs.n_dense):
        ssum = np.zeros_like(vnf)
        for tree in recs[recs[:, -1] == st]:
            wf = tree[3 * fw:-1].view(f32)
            v0, vl, vr = (feature(tree[j * fw:(j + 1) * fw]) * vnf
                          for j in range(3))
            lv = np.where(vl < wf[1], wf[3], wf[4])
            rv = np.where(vr < wf[2], wf[5], wf[6])
            ssum = ssum + np.where(v0 < wf[0], lv, rv)
        alive &= ssum >= tabs.host["stage_thr"][st]
    return vnf, alive.astype(np.uint8)


def _band_mirror(plan, work, records):
    """numpy mirror of csrc/pyramid_dense.cu: per (band, frame) block the
    2-tap resize of the band's level rows (halo included) from the packed
    tables, band-local uint32 tables, the band's level-image rows and the
    record evaluation of its windows → per level (img | None, vnf, alive)
    and the number of times each window and each image row was written."""
    t, tabs = plan._host, plan.tables
    B = work.shape[0]
    src = work.astype(np.int64)
    out, n_win, n_img = [], [], []
    for l in plan.levels:
        out.append([np.zeros((B, l.sh, l.sw), np.uint8),
                    np.zeros((B, l.ny, l.nx), np.float32),
                    np.zeros((B, l.ny, l.nx), np.uint8)])
        n_win.append(np.zeros((l.ny, l.nx), np.int64))
        n_img.append(np.zeros(l.sh, np.int64))
    n_rec = len(tabs.host["weak_i"]) * dense_cuda.TREE_WORDS
    for li, iy0, n_rows, row0, rows, own1 in plan.items.tolist():
        sw, sh, step, nx, _, same, _, _, rxo, ryo, reco = (
            int(v) for v in t["levels"][li])
        # the band's tabulated rows, and the rows it resizes: the last band
        # of a level also its bottom rows that no window reads
        ys = np.arange(row0, row0 + (rows if same else max(rows, own1 - row0)))
        if same:
            px = src[:, ys]
        else:
            rx = t["rtab"][rxo:rxo + 4 * sw].reshape(4, sw).astype(np.int64)
            ry = t["rtab"][ryo:ryo + 4 * sh].reshape(4, sh)[:, ys].astype(
                np.int64)
            h = src[:, :, rx[0]] * rx[2] + src[:, :, rx[1]] * rx[3]
            v = h[:, ry[0]] * ry[2][:, None] + h[:, ry[1]] * ry[3][:, None]
            px = np.clip((v + (1 << 15)) >> 16, 0, 255)
            own = ys[ys < own1]
            out[li][0][:, own] = px[:, :len(own)]
            n_img[li][own] += 1
        px = px[:, :rows]
        ii = np.zeros((B, rows + 1, sw + 1), np.uint32)
        sq = np.zeros_like(ii)
        ii[:, 1:, 1:] = px.cumsum(-1).cumsum(-2)
        sq[:, 1:, 1:] = (px * px).cumsum(-1).cumsum(-2)
        origin = ((np.arange(n_rows) * step)[:, None] * (sw + 1)
                  + (np.arange(nx) * step)[None, :])
        vnf, alive = _records_eval(
            records[reco:reco + n_rec].reshape(-1, dense_cuda.TREE_WORDS),
            tabs, ii.reshape(B, -1), sq.reshape(B, -1), origin, sw + 1)
        out[li][1][:, iy0:iy0 + n_rows] = vnf
        out[li][2][:, iy0:iy0 + n_rows] = alive
        n_win[li][iy0:iy0 + n_rows] += 1
    for li, l in enumerate(plan.levels):
        if t["levels"][li][5]:
            out[li][0] = None
    return out, n_win, n_img


@pytest.fixture(scope="module")
def band_plans(engines, work):
    """(plan, work images) of the pyramid kernel: the face engine at 160x90
    and 160x120 (720p and 480p frames), and the nose's 24-level launch of
    the part chain at 320x180; faces and noise."""
    _, peng = engines
    face120 = CascadeEngine(peng.cascade, (160, 120), 1.25, device="cpu")
    nose = NoseDetector((1280, 720), device="cpu").part_engines["nose"]

    def frames(size, frame_size, seed):
        face = equalize_hist(resize_linear_exact(
            torch.from_numpy(face_clip(1, *frame_size)), size))
        noise = np.random.RandomState(seed).randint(
            0, 256, (1, size[1], size[0]), np.uint8)
        return np.concatenate([face.numpy(), noise])

    return {"face 160x90": (peng._plan, work),
            "face 160x120": (face120._plan, frames((160, 120), (640, 480), 3)),
            "nose 320x180": (nose._plan, frames((320, 180), (1280, 720), 4))}


@pytest.mark.parametrize("name,n_levels,n_bands", [
    ("face 160x90", 7, 13), ("face 160x120", 9, 18),
    ("nose 320x180", 24, 88)])
def test_band_mirror_reproduces_plain_version(band_plans, name, n_levels,
                                              n_bands):
    """The pyramid kernel's band geometry, mirrored in numpy: each window
    of each level is evaluated in exactly one band and each level-image row
    written by exactly one; band-local tables and the record evaluation
    equal the plain version's whole-level result exactly. A corner offset
    moved by one in the tree records breaks the equality."""
    plan, work = band_plans[name]
    assert (len(plan.levels), len(plan.items)) == (n_levels, n_bands)
    assert plan.band_smem_bytes < max(
        dense_cuda.pyramid_smem_bytes(l) for l in plan.levels) // 2
    plan.check_fits()
    records = plan._host["records"]
    got, n_win, n_img = _band_mirror(plan, work, records)
    want = dense_cuda.pyramid_dense_phase_reference(torch.from_numpy(work),
                                                    plan)
    for li, ((gi, gv, ga), (wi, wv, wa)) in enumerate(zip(got, want)):
        assert (n_win[li] == 1).all(), li
        assert (gi is None) == (wi is None), li
        if gi is not None:
            assert (n_img[li] == 1).all(), li
            assert np.array_equal(gi, wi.numpy()), li
        assert np.array_equal(gv, wv.numpy()), li
        assert np.array_equal(ga, wa.numpy()), li
    assert sum(int(a.sum()) for _, _, a in want) > 0
    bad = records.copy()
    bad[2] += 1              # tree 0's root feature, first corner, level 0
    got, _, _ = _band_mirror(plan, work, bad)
    assert not all(np.array_equal(g[1], w[1].numpy())
                   and np.array_equal(g[2], w[2].numpy())
                   for g, w in zip(got, want))


def test_wrapper_on_cpu_runs_plain_version(engines, work):
    _, peng = engines
    x = torch.from_numpy(work)
    before = dense_cuda.pyramid_dense_phase.launches
    got = dense_cuda.pyramid_dense_phase(x, peng._plan)
    assert dense_cuda.pyramid_dense_phase.launches == before
    want = dense_cuda.pyramid_dense_phase_reference(x, peng._plan)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None and b is None) or torch.equal(a, b)


def test_wrapper_checks_inputs(engines):
    _, peng = engines
    plan = peng._plan
    with pytest.raises(TypeError):
        dense_cuda.pyramid_dense_phase(
            torch.zeros((1, 90, 160), dtype=torch.int32), plan)
    with pytest.raises(ValueError):
        dense_cuda.pyramid_dense_phase(
            torch.zeros((1, 120, 160), dtype=torch.uint8), plan)
    with pytest.raises(ValueError):
        dense_cuda.pyramid_dense_phase(
            torch.zeros((1, 160, 90), dtype=torch.uint8).transpose(1, 2),
            plan)


@pytest.mark.parametrize("work_wh,fits", [((160, 90), True),
                                          ((160, 120), True),
                                          ((320, 180), False)])
def test_plan_shared_memory_budget(engines, work_wh, fits):
    """A plan's launch takes the shared memory of its largest band (two
    band tables, the tree records and the stage thresholds), never a whole
    level's tables: at 160x90 and 160x120 every level's whole tables would
    fit one block (161*121*8 = 155,848 B), at 320x180 (factor 1.25) the
    largest two do not (`fits` False: wide levels, which the row-strip
    kernel took), and
    the engine routes all of them to the pyramid kernel in bands that do."""
    _, peng = engines
    eng = CascadeEngine(peng.cascade, work_wh, device="cpu")
    w, h = work_wh
    assert dense_cuda.pyramid_smem_bytes(eng.levels[0]) == 8 * (w + 1) * (h + 1)
    assert (dense_cuda.pyramid_smem_bytes(eng.levels[0])
            <= dense_cuda.MAX_SMEM_BYTES) == fits
    assert eng.routes == ["pyramid"] * len(eng.levels)
    plan = eng._plan
    assert plan.levels == tuple(eng.levels)
    assert plan.n_wide == (0 if fits else 2)
    plan.check_fits()
    rec = 4 * (len(eng._tables.host["weak_i"]) * dense_cuda.TREE_WORDS
               + eng._tables.n_dense)
    assert plan.staged
    assert plan.band_smem_bytes == rec + max(
        8 * (rows + 1) * (eng.levels[li].sw + 1)
        for li, _, _, _, rows, _ in plan.items.tolist())
    assert plan.band_smem_bytes <= dense_cuda.MAX_SMEM_BYTES


@pytest.fixture(scope="module")
def nose_wide():
    """The nose's four wide levels at 320x180 (320x180 .. 240x135, whose
    whole tables exceed one block) and a 720p work image of faces and
    noise."""
    nose = NoseDetector((1280, 720), device="cpu").part_engines["nose"]
    face = equalize_hist(resize_linear_exact(
        torch.from_numpy(face_clip(1, 1280, 720, seed=4)), (320, 180)))
    noise = np.random.RandomState(6).randint(0, 256, (1, 180, 320), np.uint8)
    return nose, np.concatenate([face.numpy(), noise])


@pytest.mark.parametrize("target,n_bands", [
    (dense_cuda.BAND_SMEM_TARGET, 45), (dense_cuda.MAX_SMEM_BYTES, 28),
    (0, 277)])
def test_band_mirror_on_wide_levels(nose_wide, target, n_bands):
    """The bands of the nose's four wide levels, mirrored in numpy, give
    the plain version's whole-level result exactly, with the default cut
    (three blocks an SM), with bands of a window's height (107 KB a
    block), and with bands of one grid row (target 0): each window and
    level-image row written once."""
    nose, work = nose_wide
    levels = nose.levels[:4]
    assert all(dense_cuda.pyramid_smem_bytes(l) > dense_cuda.MAX_SMEM_BYTES
               for l in levels)
    plan = dense_cuda.PyramidDensePlan((320, 180), levels, nose._tables,
                                       band_target=target)
    assert len(plan.items) == n_bands and plan.n_wide == 4
    if target == 0:
        assert (plan.items[:, 2] == 1).all()
    else:
        assert plan.band_smem_bytes <= target
    got, n_win, n_img = _band_mirror(plan, work, plan._host["records"])
    want = dense_cuda.pyramid_dense_phase_reference(torch.from_numpy(work),
                                                    plan)
    for li, ((gi, gv, ga), (wi, wv, wa)) in enumerate(zip(got, want)):
        assert (n_win[li] == 1).all(), li
        if gi is not None:
            assert (n_img[li] == 1).all(), li
            assert np.array_equal(gi, wi.numpy()), li
        assert np.array_equal(gv, wv.numpy()), li
        assert np.array_equal(ga, wa.numpy()), li
    assert sum(int(a.sum()) for _, _, a in want) > 0


@pytest.mark.parametrize("where", ["env", "checkout", "installed"])
def test_kernel_build_dir(where, monkeypatch, tmp_path):
    """Kernels build into $NUBOMEDIA_VCA_KERNEL_DIR, else the checkout's
    build/torch_kernels/, else (an installed package) a per-user cache."""
    monkeypatch.delenv("NUBOMEDIA_VCA_KERNEL_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if where == "env":
        monkeypatch.setenv("NUBOMEDIA_VCA_KERNEL_DIR", str(tmp_path / "k"))
        want = tmp_path / "k"
    elif where == "checkout":
        want = _build.PKG_DIR.parent / "build" / "torch_kernels"
        assert (_build.PKG_DIR.parent / "pyproject.toml").is_file()
    else:
        monkeypatch.setattr(_build, "PKG_DIR",
                            tmp_path / "site-packages" / "pkg")
        want = (tmp_path / "home" / ".cache" / "nubomedia_vca_tpu_torch"
                / "kernels")
    assert _build.build_dir() == want
