"""The level kernels of the PyTorch port on the CPU, through their plain
versions, against the JAX package's Pallas kernels in interpret mode:

* ``integral_cuda.integral_tables`` (``csrc/integral_tables.cu``) against
  ``integral_images_pallas``;
* ``dense_level_cuda`` in its tilted form (``csrc/dense_level.cu``: table
  pass, tilted table from the sum table, tiled evaluation), whose plain
  version evaluates tile by tile in the kernel's tile geometry, against
  ``build_dense_phase`` on a tilted cascade in several tile geometries (a
  level smaller than one tile, ragged last tiles), as
  ``tests/test_pallas_ops.py`` checks the Pallas kernel; on a level larger
  than one block's shared memory could hold whole, against the JAX
  engine's XLA dense phase; and in three tile sizes against a whole-level
  evaluation;
* the tilted-table kernel's plain version against the image's tilted
  table;
* the row-strip form of ``build_dense_phase``, which the pyramid kernel's
  bands (``dense_cuda.pyramid_dense_phase``) replace: the Pallas strip
  kernel (forced to several strips through the JAX engine instance's
  ``PALLAS_DENSE_MAX_ELEMS``) against the pyramid kernel's plain version,
  and bands of every height down to one grid row (the numpy mirror of
  ``tests/test_torch_dense_kernel.py``) against the whole level;
* a numpy mirror of ``csrc/dense_level.cu`` (the tilted table along the
  diagonals, the staged tiles, the tree records with their corner
  offsets) against the plain version: the layout the CUDA kernels read,
  which only a GPU can run;
* the engine's per-level routing at the part chain's 720p geometry, and
  the widest level the pyramid kernel takes.

The CUDA kernels themselves are held to their plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import os

import jax
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
from nubomedia_vca_tpu_torch.ops.cuda import (dense_cuda, dense_level_cuda,
                                              integral_cuda)
from nubomedia_vca_tpu_torch.ops.cuda.dense_cuda import (FEAT_WORDS,
                                                         MAX_SMEM_BYTES,
                                                         TREE_WORDS,
                                                         PyramidDensePlan,
                                                         pyramid_dense_phase,
                                                         pyramid_fits)
from nubomedia_vca_tpu_torch.ops.cuda.dense_level_cuda import (
    DenseLevelPlan, dense_level_reference)
from nubomedia_vca_tpu_torch.ops.integral import (integral_image,
                                                  sq_integral_image,
                                                  tilted_integral_image)
from nubomedia_vca_tpu_torch.utils.synth import face_scene

from .test_torch_dense_kernel import _band_mirror

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
    kernel in interpret mode (112x199: a tilted level of the part chain at
    720p); the CPU wrapper runs it and launches nothing."""
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


def _integral_band_mirror(img, seed):
    """numpy mirror of csrc/integral_tables.cu, uint32 throughout: per band
    of band_rows(H, W) rows (tickets in order, frame-major), the row
    prefixes and the in-band column prefix; its aggregate and inclusive
    prefix; the carry from a look-back that finds each band above either
    with its inclusive prefix published (and stops there) or only with its
    aggregate, at random; then the band's table rows. → (ii, sq, number of
    writes of each table word)."""
    B, H, W = img.shape
    R, n_bands = integral_cuda.band_geometry(H, W)
    rng = np.random.RandomState(seed)
    ii = np.zeros((B, H + 1, W + 1), np.uint32)
    sq = np.zeros_like(ii)
    writes = np.zeros((B, H + 1, W + 1), np.int64)
    agg, incl = {}, {}
    for t in range(B * n_bands):
        b, band = divmod(t, n_bands)
        row0 = band * R
        x = img[b, row0:row0 + R].astype(np.uint32)
        band_ii = x.cumsum(1, dtype=np.uint32).cumsum(0, dtype=np.uint32)
        band_sq = (x * x).cumsum(1, dtype=np.uint32).cumsum(0, dtype=np.uint32)
        carry = np.zeros((2, W), np.uint32)
        for j in range(t - 1, t - band - 1, -1):
            if j == t - band or rng.rand() < 0.5:   # band 0 is always done
                carry += incl[j]
                break
            carry += agg[j]
        if len(x):
            agg[t] = np.stack([band_ii[-1], band_sq[-1]])
            incl[t] = carry + agg[t]
        if band == 0:
            writes[b, 0] += 1
        rows = slice(row0 + 1, row0 + 1 + len(x))
        ii[b, rows, 1:] = carry[0] + band_ii
        sq[b, rows, 1:] = carry[1] + band_sq
        writes[b, rows] += 1
    return ii.view(np.int32), sq.view(np.int32), writes


@pytest.mark.parametrize("hw,n_bands", [
    ((180, 320), 12), ((112, 199), 5), ((37, 53), 1), ((1, 1), 1),
    ((15, 320), 1), ((16, 320), 1), ((17, 320), 2), ((33, 320), 3)])
def test_integral_band_mirror_matches_plain(hw, n_bands):
    """The banded scan with look-back carries, mirrored in numpy, equals the
    plain version on images with the largest sums; each table word is
    written once. At 320 columns a band is 16 rows: heights R - 1, R, R + 1
    and 2R + 1 put the last band's edge on each side of a band boundary."""
    img = _u8(sum(hw), (3,) + hw)
    img[0] = 255
    assert integral_cuda.band_geometry(*hw)[1] == n_bands
    ii, sq, writes = _integral_band_mirror(img, seed=sum(hw))
    want = integral_cuda.integral_tables_reference(torch.from_numpy(img))
    assert (writes == 1).all()
    assert np.array_equal(ii, want[0].numpy())
    assert np.array_equal(sq, want[1].numpy())


def test_integral_band_geometry_fits_shared_memory():
    """Bands hold about BAND_PIXELS pixels and their shared memory fits a
    block; an image row too wide for one block raises."""
    for H, W in [(180, 320), (720, 1280), (20, 22), (1, 5000)]:
        rows, n = integral_cuda.band_geometry(H, W)
        assert rows * n >= H and (n - 1) * rows < max(H, 1)
        assert integral_cuda.band_smem_bytes(rows, W) <= MAX_SMEM_BYTES
        assert rows == min(H, max(1, integral_cuda.BAND_PIXELS // W))
    with pytest.raises(ValueError, match="shared memory"):
        integral_cuda.band_rows(4, 20_000)


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


@pytest.fixture(scope="module")
def pallas_levels(tilted_engines):
    """Per level of the 48x40 engine: noise [2, sh, sw] and the Pallas
    kernel's (ii, iit, vnf, alive) on it, in interpret mode."""
    jeng, peng = tilted_engines
    out = []
    for li, l in enumerate(peng.levels):
        img = _u8(li + 7, (2, l.sh, l.sw))
        want = build_dense_phase(jeng, l.sh, l.sw, l.ystep)(
            jnp.asarray(img), interpret=True)
        out.append((img, [np.asarray(w) for w in want]))
    return out


@pytest.mark.parametrize("tile,n_tiles", [
    ((16, 16), [(1, 1)] * 4),      # every level smaller than one tile
    ((4, 6), [(3, 3), (2, 2), (1, 1), (1, 1)]),  # ragged last tiles
    ((3, 16), [(4, 1), (3, 1), (2, 1), (1, 1)])])
def test_tilted_plain_matches_pallas(tilted_engines, pallas_levels, tile,
                                     n_tiles):
    """The tilted form's plain version, tile by tile in the kernel's tile
    geometry, against the Pallas kernel on every level of noise: ii and
    iit exact, vnf exact to the unfused formula and within the XLA:CPU
    bound, alive exact and non-empty."""
    _, peng = tilted_engines
    assert peng.routes == ["tilted"] * len(peng.levels)
    assert [(l.ny, l.nx) for l in peng.levels] == [(11, 15), (7, 10),
                                                   (4, 6), (1, 3)]
    n_alive = 0
    for li, (l, (img, (w_ii, w_iit, w_vnf, w_alive))) in enumerate(
            zip(peng.levels, pallas_levels)):
        plan = DenseLevelPlan.make(l, peng._tables, tile=tile)
        assert plan.n_tiles == n_tiles[li]
        ii, iit, vnf, alive = dense_level_reference(torch.from_numpy(img),
                                                    plan)
        assert np.array_equal(ii.numpy(), w_ii)
        assert np.array_equal(iit.numpy(), w_iit)
        assert np.array_equal(alive.numpy(), w_alive.astype(np.uint8))
        _check_vnf(img, l, peng._tables, vnf.numpy(), w_vnf)
        n_alive += int(alive.sum())
    assert n_alive > 0


@pytest.fixture(scope="module")
def large_tilted_level():
    """A 199x112 level (ystep 2, 47x90 windows) of the left eye's first 3
    stages: larger than one block's shared memory could hold whole
    (12 B x 113 x 200 > 232,448 B). Two equalized face frames and noise;
    the JAX engine's XLA dense phase on them (its Pallas dense phase off,
    as the JAX package runs off the TPU), taken from ``_eval_level``."""
    casc = _truncated(load_cascade_xml(
        os.path.join(OPENCV_DIR, "haarcascade_lefteye_2splits.xml")), 3)
    jeng = JaxEngine(casc, (199, 112), 1.1, use_pallas_dense=False)
    peng = CascadeEngine(cascade_from_numpy(dataclasses.asdict(casc)),
                         (199, 112), 1.1, device="cpu")
    l = peng.levels[0]
    assert (l.sw, l.sh, l.ystep, l.ny, l.nx) == (199, 112, 2, 47, 90)
    assert 12 * (l.sh + 1) * (l.sw + 1) > MAX_SMEM_BYTES
    faces = np.stack([face_scene(199, 112, faces=((60, 56, 60), (150, 50, 44)),
                                 seed=s) for s in range(2)])
    img = np.concatenate([faces, _u8(8, (1, 112, 199))])
    jeng._level_post = lambda li, img, ii, iit, vnf, alive: (ii, iit, vnf,
                                                               alive)
    want = jax.jit(lambda g: jeng._eval_level(g, 0))(jnp.asarray(img))
    return peng, l, img, [np.asarray(w) for w in want]


def test_tilted_plain_matches_xla_on_large_level(large_tilted_level):
    """The tiled plain version against the JAX engine's XLA dense phase on a
    level too large for one block: ii and iit exact, alive exact and
    non-empty, vnf exact to the unfused formula and within the XLA:CPU
    bound."""
    peng, l, img, (w_ii, w_iit, w_vnf, w_alive) = large_tilted_level
    plan = peng._level_plans[0]
    assert peng.routes[0] == "tilted" and plan.n_tiles == (3, 6)
    ii, iit, vnf, alive = dense_level_reference(torch.from_numpy(img), plan)
    assert np.array_equal(ii.numpy(), w_ii)
    assert np.array_equal(iit.numpy(), w_iit)
    assert np.array_equal(alive.numpy(), w_alive.astype(np.uint8))
    assert alive.sum() > 0
    _check_vnf(img, l, peng._tables, vnf.numpy(), w_vnf)


@pytest.mark.parametrize("tile,n_tiles", [((16, 16), (3, 6)),
                                          ((5, 7), (10, 13)),
                                          ((2, 128), (24, 1))])
def test_tile_size_does_not_change_result(large_tilted_level, tile, n_tiles):
    """Any tile geometry gives the whole-level evaluation exactly (vnf and
    alive), through the CPU wrapper, which launches nothing."""
    peng, l, img, _ = large_tilted_level
    plan = DenseLevelPlan.make(l, peng._tables, tile=tile)
    assert plan.n_tiles == n_tiles
    x = torch.from_numpy(img)
    before = (dense_level_cuda.dense_level_tilted.launches,
              dense_level_cuda.tilted_table.launches,
              integral_cuda.integral_tables.launches)
    ii, iit, vnf, alive = dense_level_cuda.dense_level_tilted(x, plan)
    assert (dense_level_cuda.dense_level_tilted.launches,
            dense_level_cuda.tilted_table.launches,
            integral_cuda.integral_tables.launches) == before
    whole = peng._tables.evaluate(ii, sq_integral_image(x), iit, l.ny, l.nx,
                                  l.ystep)
    assert torch.equal(vnf, whole[0]) and torch.equal(alive, whole[1])
    assert alive.sum() > 0


@pytest.mark.parametrize("hw", [(180, 320), (37, 53), (1, 1)])
def test_tilted_table_plain_matches_tilted_integral(hw):
    """The tilted-table kernel's plain version (from the sum table) and its
    numpy mirror (the kernel's diagonal passes) equal the image's tilted
    table, also at the largest sums; the CPU wrapper launches nothing."""
    img = _u8(sum(hw), (3,) + hw)
    img[0] = 255
    x = torch.from_numpy(img)
    ii = integral_image(x)
    before = dense_level_cuda.tilted_table.launches
    got = dense_level_cuda.tilted_table(ii)
    assert dense_level_cuda.tilted_table.launches == before
    want = tilted_integral_image(x)
    assert torch.equal(got, want)
    mirror = _tilted_table_mirror(ii.numpy().view(np.uint32))
    assert np.array_equal(mirror.view(np.int32), want.numpy())
    with pytest.raises(TypeError):
        dense_level_cuda.tilted_table(integral_image(x).to(torch.int64))


def test_tilted_tile_too_large_raises():
    """A tilted level whose tile of windows cannot fit shared memory has no
    route: engine construction raises on every device; a plan refuses a
    tile over its shared-memory budget."""
    casc = port_load(os.path.join(PKG_ASSETS_DIR,
                                  "haarcascade_righteye_2splits.xml"))
    big = dataclasses.replace(casc, window_w=240, window_h=240)
    with pytest.raises(NotImplementedError, match="no dense kernel"):
        CascadeEngine(big, (320, 320), 1.1, device="cpu")
    eng = CascadeEngine(casc, (64, 48), 1.1, device="cpu")
    smem = 4 * (3 * 49 * 51 + 46 * TREE_WORDS + 6)   # tables, 46 trees
    assert DenseLevelPlan.make(eng.levels[0], eng._tables).smem_bytes == smem
    with pytest.raises(ValueError, match="tile"):
        DenseLevelPlan.make(eng.levels[0], eng._tables,
                            max_smem=smem - 1)


def test_tilted_wrapper_on_cpu_runs_plain_version(tilted_engines):
    _, peng = tilted_engines
    plan = peng._level_plans[0]
    x = torch.from_numpy(_u8(3, (2, plan.level.sh, plan.level.sw)))
    before = dense_level_cuda.dense_level_tilted.launches
    got = dense_level_cuda.dense_level_tilted(x, plan)
    assert dense_level_cuda.dense_level_tilted.launches == before
    for g, w in zip(got, dense_level_reference(x, plan)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        dense_level_cuda.dense_level_tilted(x[:, 1:], plan)
    with pytest.raises(TypeError):
        dense_level_cuda.dense_level_tilted(x.to(torch.int32), plan)


# ------------------------------------------------------------------ #3
@pytest.fixture(scope="module")
def strip_case():
    """The face cascade's dense block on a tall 60x150 level (ystep 2, 131
    window-origin rows) of faces and noise."""
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
    """The Pallas strip kernel in three strips (the last ragged; forced
    through PALLAS_DENSE_MAX_ELEMS on the JAX engine instance) against the
    plain version of the pyramid kernel, whose bands carry such levels now:
    alive exact and non-empty, vnf exact to the unfused formula and within
    the XLA:CPU bound; the wrapper on a CPU tensor launches nothing."""
    jeng, peng, l, img = strip_case
    jeng.PALLAS_DENSE_MAX_ELEMS = 61 * 84     # strip_gy 64: 3 strips
    w_ii, w_iit, w_vnf, w_alive = build_dense_phase(
        jeng, l.sh, l.sw, l.ystep)(jnp.asarray(img), interpret=True)
    assert w_ii is None and w_iit is None
    plan = PyramidDensePlan((l.sw, l.sh), [l], peng._tables)
    assert len(plan.items) == 3
    before = pyramid_dense_phase.launches
    [(img_l, vnf, alive)] = pyramid_dense_phase(torch.from_numpy(img), plan)
    assert pyramid_dense_phase.launches == before and img_l is None
    assert np.array_equal(alive.numpy(), np.asarray(w_alive).astype(np.uint8))
    assert alive.sum() > 0
    _check_vnf(img, l, peng._tables, vnf.numpy(), np.asarray(w_vnf))


@pytest.mark.parametrize("target,n_bands", [(MAX_SMEM_BYTES, 3),
                                            (8 * 61 * 43, 33),
                                            (0, 66)])
def test_strip_count_does_not_change_result(strip_case, target, n_bands):
    """Any band cut of the pyramid kernel gives the whole-level result
    (numpy mirror of the kernel's bands against the whole-level
    evaluation): the default cut, bands of two grid rows, and one grid
    row per band."""
    _, peng, l, img = strip_case
    plan = PyramidDensePlan((l.sw, l.sh), [l], peng._tables,
                            band_target=target)
    assert len(plan.items) == n_bands
    [(_, vnf, alive)], n_win, _ = _band_mirror(plan, img,
                                               plan._host["records"])
    assert (n_win[0] == 1).all()
    x = torch.from_numpy(img)
    whole = peng._tables.evaluate(integral_image(x), sq_integral_image(x),
                                  None, l.ny, l.nx, l.ystep)
    assert np.array_equal(vnf, whole[0].numpy())
    assert np.array_equal(alive, whole[1].numpy())


# ------------------------------------------------------ kernel mirror
def _tables_mirror(x):
    """uint32 sum and squared-sum tables of uint8 pixels [B, rows, sw]."""
    x = x.astype(np.int64)
    ii = np.zeros((x.shape[0], x.shape[1] + 1, x.shape[2] + 1), np.uint32)
    sq = np.zeros_like(ii)
    ii[:, 1:, 1:] = x.cumsum(-1).cumsum(-2)
    sq[:, 1:, 1:] = (x * x).cumsum(-1).cumsum(-2)
    return ii, sq


def _tilted_table_mirror(ii):
    """numpy mirror of tilted_table_kernel, uint32 throughout: A carried
    along each anti-diagonal x + y = d (from 0, or from ii[y][W] where it
    enters at column W) and written, then D carried along each diagonal
    x - y (from 0 at column 0) and subtracted, a row at a time as a warp
    steps its diagonals."""
    B, H, W = ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1
    iit = np.zeros_like(ii)
    diag = np.arange(W + H + 1)
    a = np.zeros((B, W + H + 1), np.uint32)
    for y in range(1, H + 1):
        on = (diag - y >= 0) & (diag - y <= W)
        x = diag[on] - y
        xc = np.minimum(x, W - 1)
        a[:, on] = np.where(x == W, ii[:, y, W][:, None],
                            a[:, on] + ii[:, y, xc] - ii[:, y - 1, xc])
        iit[:, y, x] = a[:, on]
    dsum = np.zeros((B, W + H + 1), np.uint32)
    for y in range(1, H + 1):
        on = (diag - H + y >= 1) & (diag - H + y <= W)
        x = diag[on] - H + y
        dsum[:, on] += ii[:, y, x - 1] - ii[:, y - 1, x - 1]
        iit[:, y, x] -= dsum[:, on]
    return iit


def _records_mirror(plan, ii, sq, iit, origin):
    """The evaluation kernel's window loop over the plan's tree records:
    flat staged tables [B, tile_rows * pitch] (uint32), window origins
    [rows, cols] as flat offsets; corner offsets from the records, float32
    throughout."""
    tabs, f32 = plan.tables, np.float32

    def feature(f):
        t = iit if f[1] else ii
        val = None
        for r in range(f[0]):
            o = f[2 + 4 * r:6 + 4 * r]
            s = (t[:, origin + o[0]] - t[:, origin + o[1]]
                 - t[:, origin + o[2]] + t[:, origin + o[3]])
            term = s.view(np.int32).astype(f32) * f[14 + r:15 + r].view(f32)
            val = term if val is None else val + term
        return val

    p, nw, nh = plan.pitch, tabs.norm_w, tabs.norm_h
    n0, n2 = p + 1, (1 + nh) * p + 1

    def norm_rect(t):
        return (t[:, origin + n0] - t[:, origin + n0 + nw]
                - t[:, origin + n2] + t[:, origin + n2 + nw])

    vf = norm_rect(ii).view(np.int32).astype(f32)
    nf = f32(tabs.norm_area) * norm_rect(sq).astype(f32) - vf * vf
    alive = nf > f32(tabs.var_thr)
    vnf = np.where(alive, f32(1) / np.sqrt(np.maximum(nf, f32(1e-20))),
                   f32(1))
    for st in range(tabs.n_dense):
        ssum = np.zeros_like(vnf)
        for tree in plan.records[plan.records[:, -1] == st]:
            wf = tree[3 * FEAT_WORDS:-1].view(f32)
            v0, vl, vr = (feature(tree[j * FEAT_WORDS:(j + 1) * FEAT_WORDS])
                          * vnf for j in range(3))
            lv = np.where(vl < wf[1], wf[3], wf[4])
            rv = np.where(vr < wf[2], wf[5], wf[6])
            ssum = ssum + np.where(v0 < wf[0], lv, rv)
        alive &= ssum >= tabs.host["stage_thr"][st]
    return vnf, alive


def _level_kernel_mirror(plan, img):
    """numpy mirror of csrc/dense_level.cu: the level's tables, the tilted
    table along the diagonals, then per (tile, frame) block the tile's
    window of the three tables staged at the plan's row length, and the
    window loop over the plan's tree records there."""
    l, h0, w0 = plan.level, plan.tables.window_h, plan.tables.window_w
    B, step = img.shape[0], l.ystep
    vnf_out = np.zeros((B, l.ny, l.nx), np.float32)
    alive_out = np.zeros((B, l.ny, l.nx), np.uint8)
    ii, sq = _tables_mirror(img)
    iit = _tilted_table_mirror(ii)
    for iy0, n_rows, ix0, n_cols in plan.tiles():
        r0, c0 = iy0 * step, ix0 * step
        rows = slice(r0, r0 + (n_rows - 1) * step + h0 + 1)
        cols = slice(c0, c0 + (n_cols - 1) * step + w0 + 1)
        staged = []
        for t in (ii, sq, iit):
            s = np.zeros((B, plan.tile_rows, plan.pitch), np.uint32)
            part = t[:, rows, cols]
            s[:, :part.shape[1], :part.shape[2]] = part
            staged.append(s.reshape(B, -1))
        vnf, alive = _records_mirror(
            plan, *staged, (np.arange(n_rows) * step)[:, None] * plan.pitch
            + (np.arange(n_cols) * step)[None, :])
        vnf_out[:, iy0:iy0 + n_rows, ix0:ix0 + n_cols] = vnf
        alive_out[:, iy0:iy0 + n_rows, ix0:ix0 + n_cols] = alive
    return ii.view(np.int32), iit.view(np.int32), vnf_out, alive_out


def test_level_kernel_tables_reproduce_plain_version(tilted_engines,
                                                     strip_case):
    """The level kernels, mirrored in numpy from the packed records: the
    tilted form on the tilted cascade's largest level in one tile and in
    3x3 ragged tiles; a level the row-strip kernel took, in the pyramid
    kernel's bands of one grid row."""
    _, peng_t = tilted_engines
    _, peng_s, l, img = strip_case
    l_t = peng_t.levels[0]
    x_t = _u8(21, (2, l_t.sh, l_t.sw))
    for plan, x in [(peng_t._level_plans[0], x_t),
                    (DenseLevelPlan.make(l_t, peng_t._tables, tile=(4, 6)),
                     x_t)]:
        got = _level_kernel_mirror(plan, x)
        want = dense_level_reference(torch.from_numpy(x), plan)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())
        assert want[3].sum() > 0
    plan = PyramidDensePlan((l.sw, l.sh), [l], peng_s._tables,
                            band_target=0)
    [(_, vnf, alive)], _, _ = _band_mirror(plan, img, plan._host["records"])
    [(_, w_vnf, w_alive)] = dense_cuda.pyramid_dense_phase_reference(
        torch.from_numpy(img), plan)
    assert np.array_equal(vnf, w_vnf.numpy())
    assert np.array_equal(alive, w_alive.numpy()) and alive.sum() > 0


# ------------------------------------------------------------- routing
def test_routing_at_720p():
    """The route of every level of the part chain's engines at 1280x720
    (host geometry only): the face pass at 160x90 all in the pyramid
    kernel; the nose at 320x180: all 24 levels in one pyramid launch, the
    four whose whole tables exceed shared memory (the row-strip kernel's
    before) in bands of 4-10 grid rows, at most 77 KB a block (three an
    SM); the mouth and
    eyes: every level in the tilted kernels, 320x180 included, with 16x16
    tiles of windows (49x67 table entries of each table for the smile's
    36x18 window, 51x51 for the eyes' 20x20) and the tree records in shared
    memory."""
    def eng(name, size, factor, min_size):
        return CascadeEngine(port_load(os.path.join(PKG_ASSETS_DIR, name)),
                             size, factor, min_size=min_size, device="cpu")

    face = eng("haarcascade_frontalface_alt.xml", (160, 90), 1.25, (3, 3))
    assert face.routes == ["pyramid"] * 7
    nose = eng("vca_nose_synthetic.xml", (320, 180), 1.1, (1, 1))
    assert nose.routes == ["pyramid"] * 24 and not nose._level_plans
    assert [(l.sw, l.sh) for l in nose.levels[3:5]] == [(240, 135),
                                                        (219, 123)]
    plan = nose._plan
    assert plan.levels == tuple(nose.levels) and plan.n_wide == 4
    bands = [plan.items[plan.items[:, 0] == li, 2].tolist()
             for li in range(4)]
    assert bands == [[5] * 13 + [4] * 4, [6] * 8 + [5] * 5,
                     [8] * 2 + [7] * 7, [10] * 4 + [9] * 2]
    assert plan.band_smem_bytes == 8 * 39 * 241 + 4 * (
        len(nose._tables.host["weak_i"]) * TREE_WORDS + nose._tables.n_dense)
    assert plan.band_smem_bytes <= dense_cuda.BAND_SMEM_TARGET
    for name, min_size, n_levels, (rows, pitch), tiles in [
            ("haarcascade_smile.xml", (1, 1), 23, (49, 67), (6, 9)),
            ("haarcascade_righteye_2splits.xml", (20, 20), 24, (51, 51),
             (6, 10)),
            ("haarcascade_lefteye_2splits.xml", (20, 20), 24, (51, 51),
             (6, 10))]:
        e = eng(name, (320, 180), 1.1, min_size)
        assert e.routes == ["tilted"] * n_levels, name
        assert (e.levels[5].sw, e.levels[5].sh) == (199, 112)
        assert (e.levels[6].sw, e.levels[6].sh) == (181, 102)
        plans = [e._level_plans[li] for li in range(n_levels)]
        assert (plans[0].tile_ny, plans[0].tile_nx) == (16, 16)
        assert plans[0].n_tiles == tiles
        assert (plans[0].tile_rows, plans[0].pitch) == (rows, pitch)
        n_weak = len(e._tables.host["weak_i"])
        assert plans[0].records.shape == (n_weak, TREE_WORDS)
        assert max(p.smem_bytes for p in plans) == plans[0].smem_bytes == 4 * (
            3 * rows * pitch + n_weak * TREE_WORDS + e._tables.n_dense)
        assert plans[0].smem_bytes < MAX_SMEM_BYTES // 4
        assert e._plan is None and not hasattr(e, "_patch_dtype")
        assert not any(hasattr(b, "w_sum") for b in e._blocks)
        assert [len(e._survivor_plans[li]) for li in range(n_levels)] == [
            len(e._blocks)] * n_levels and len(e._blocks) == 2


def test_level_too_wide_raises():
    """A non-tilted level too wide for even a band of one grid row has no
    route: construction raises and names what is missing."""
    casc = port_load(os.path.join(PKG_ASSETS_DIR,
                                  "haarcascade_frontalface_alt.xml"))
    with pytest.raises(NotImplementedError, match="no dense kernel"):
        CascadeEngine(casc, (16000, 40), 1.25, device="cpu")


def _old_strip_limit(l, win_h):
    """Whether the row-strip kernel the pyramid kernel's bands replace
    took level `l`: a strip of one window row's origins (strip_gy = ystep)
    and its win_h - 1 halo rows, both tables in shared memory."""
    max_rows = MAX_SMEM_BYTES // (8 * (l.sw + 1)) - 1
    return (max_rows - win_h + 1) // l.ystep * l.ystep >= l.ystep


@pytest.mark.parametrize("win,widest,old_widest", [((20, 20), 1382, 1319),
                                                   ((24, 24), 1161, 1116)])
def test_route_boundary(win, widest, old_widest):
    """The widest non-tilted level the pyramid kernel takes (a band of one
    grid row, ystep 2): 1382 px for a 20-px window, 1161 px for a 24-px
    one; every level the row-strip kernel took (up to 1319 and 1116 px) is
    taken. At the boundary a band's tables leave no room for the tree
    records, which the launch's blocks then read through L1; one column
    more and the engine raises."""
    def level(sw):
        return _level(sw, 60, 2, win)

    assert pyramid_fits(level(widest), win[1])
    assert not pyramid_fits(level(widest + 1), win[1])
    assert _old_strip_limit(level(old_widest), win[1])
    assert not _old_strip_limit(level(old_widest + 1), win[1])
    assert all(pyramid_fits(level(sw), win[1])
               for sw in range(win[0], old_widest + 1))
    casc = port_load(os.path.join(PKG_ASSETS_DIR,
                                  "haarcascade_frontalface_alt.xml"))
    casc = dataclasses.replace(casc, window_w=win[0], window_h=win[1])
    eng = CascadeEngine(casc, (widest, 60), 1.25, device="cpu")
    assert eng.routes[0] == "pyramid"
    plan = eng._plan
    first = plan.items[plan.items[:, 0] == 0]
    assert (first[:, 2] == 1).all()
    assert not plan.staged                         # records through L1
    assert plan.band_smem_bytes == 8 * (win[1] + 1) * (widest + 1)
    plan.check_fits()
    with pytest.raises(NotImplementedError, match="no dense kernel"):
        CascadeEngine(casc, (widest + 1, 60), 1.25, device="cpu")
