"""The PyTorch port's ear detector against the JAX package's on the CPU.

Frames: two 640x480 frames of cartoon profile heads drawn with numpy
(``utils/synth.profile_scene``), one facing left (found by the normal
pass) and one facing right (found by the flipped pass), at
``width_to_process=160``, so that the JAX engines compile small. With the
default pairing (synthetic ear, synthetic profile cascade) two
``process`` calls of one stream must return identical per-frame outputs,
and the device pass's raw results (grouped profile faces, compacted ear
candidates) must be equal slot for slot on both halves of the [normal,
flipped] batch, each half finding profile faces and ears. The real
``haarcascade_profileface.xml`` (the port's bundled copy) runs the same
comparison; it finds no face on cartoons, so its dense phase is checked
to keep windows alive. The bundled cascades are byte-identical to their
sources.
"""

from __future__ import annotations

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.models.ear import EarDetector as JaxEar
from nubomedia_vca_tpu.models.ear import EarDetectorConfig as JaxEarConfig
from nubomedia_vca_tpu_torch.cascade.paths import PKG_ASSETS_DIR
from nubomedia_vca_tpu_torch.models import EarDetector, EarDetectorConfig
from nubomedia_vca_tpu_torch.ops.cuda import dense_cuda
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact
from nubomedia_vca_tpu_torch.utils.synth import profile_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = (640, 480)
REAL_PROFILE = os.path.join(PKG_ASSETS_DIR, "haarcascade_profileface.xml")
SOURCES = {
    "vca_profileface_synthetic.xml": os.path.join(
        REPO, "nubomedia_vca_tpu/assets/haarcascades"),
    "vca_ear_synthetic.xml": os.path.join(
        REPO, "nubomedia_vca_tpu/assets/haarcascades"),
    "haarcascade_profileface.xml": "/usr/share/opencv4/haarcascades",
}


@pytest.fixture(scope="module")
def clip():
    return np.stack([profile_scene(
        *FRAME, heads=((170 + 3 * t, 240, 120, "left"),
                       (470 - 3 * t, 240, 120, "right")), seed=t)
        for t in range(2)])


@pytest.fixture(scope="module", params=["default", "real_profile"])
def detectors(request):
    face = None if request.param == "default" else REAL_PROFILE
    return (request.param,
            EarDetector(FRAME, EarDetectorConfig(width_to_process=160,
                                                 face_cascade_path=face),
                        device="cpu"),
            JaxEar(FRAME, JaxEarConfig(width_to_process=160,
                                       face_cascade_path=face)))


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_bundled_cascade_is_byte_identical(name):
    src = os.path.join(SOURCES[name], name)
    if not os.path.exists(src):
        pytest.skip(f"{src} is not on this host")
    assert filecmp.cmp(os.path.join(PKG_ASSETS_DIR, name), src,
                       shallow=False)


def test_default_pairing_and_routes(detectors):
    name, pdet, jdet = detectors
    assert os.path.basename(pdet._part_cascade_paths["ear"]) == \
        "vca_ear_synthetic.xml"
    want = ("vca_profileface_synthetic.xml" if name == "default"
            else "haarcascade_profileface.xml")
    assert os.path.basename(pdet.config.face_cascade_path) == want
    assert os.path.basename(jdet.config.face_cascade_path) == want
    for eng in (pdet.face_engine, pdet.part_engines["ear"]):
        assert not eng._uses_tilt
        assert eng.routes == ["pyramid"] * len(eng.levels)


def test_process_matches_jax(detectors, clip):
    name, pdet, jdet = detectors
    for _ in range(2):
        got = pdet.process(clip)
        assert got == jdet.process(clip)
    if name == "default":
        ears = [e for r in got for e in r["ear"]]
        assert all(r["face_profile"] for r in got)
        assert min(x for x, _, _, _ in ears) < FRAME[0] // 2
        assert max(x for x, _, _, _ in ears) > FRAME[0] // 2


def test_device_pass_matches_jax(detectors, clip):
    """Raw results slot for slot on both halves of the [normal, flipped]
    batch; with the default pairing each half finds profile faces and
    ears on the first frame."""
    name, pdet, jdet = detectors
    (face, parts), (w_face, w_parts) = (pdet._device_pass(clip),
                                        jdet._device_pass(clip))
    assert pdet._n_real == jdet._n_real == 2
    for g, w in zip(face, w_face):
        assert g.shape[0] == 4 and np.array_equal(g, np.asarray(w))
    for g, w in zip(parts["ear"], w_parts["ear"]):
        assert np.array_equal(g, np.asarray(w))
    if name != "default":
        return
    assert (face[1].sum(1) > 0).all()
    assert (parts["ear"][1].sum(1) > 0).all()
    pdet._face_raw = face
    for idx, flipped in ((0, False), (2, True)):
        faces, ears = pdet._side_detections(parts, idx, flipped)
        assert faces and ears, (idx, flipped)


def test_real_profile_dense_phase_is_not_vacuous(clip):
    eng = EarDetector(FRAME, EarDetectorConfig(
        width_to_process=160, face_cascade_path=REAL_PROFILE),
        device="cpu").face_engine
    both = torch.from_numpy(np.concatenate([clip, clip[:, :, ::-1]]))
    work = equalize_hist(resize_linear_exact(both, (eng.image_w,
                                                    eng.image_h)))
    levels = dense_cuda.pyramid_dense_phase(work, eng._plan)
    assert sum(int(alive.sum()) for _, _, alive in levels) > 0


def test_side_coordinates_match_jax_at_odd_width():
    """Host coordinate logic on a frame width that 160 does not divide:
    the same grouped faces and ear candidates give the same boxes, the
    flipped side mirrored back, in both packages."""
    size = (854, 480)
    pdet = EarDetector(size, EarDetectorConfig(width_to_process=160),
                       device="cpu")
    jdet = JaxEar(size, JaxEarConfig(width_to_process=160))
    rng = np.random.RandomState(7)
    n = 2                                     # real frames; 2n in the batch
    fboxes = np.zeros((2 * n, 64, 4), np.int32)
    fvalid = np.zeros((2 * n, 64), bool)
    eboxes = np.zeros((2 * n, 256, 4), np.int32)
    evalid = np.zeros((2 * n, 256), bool)
    for b in range(2 * n):
        fboxes[b, :3] = [(rng.randint(0, 100), rng.randint(0, 40),
                          s, s) for s in rng.randint(25, 60, 3)]
        fvalid[b, :3] = True
        x0, y0, s = fboxes[b, 0, 0], fboxes[b, 0, 1], fboxes[b, 0, 2]
        for k in range(6):                    # a cluster inside face 0's ROI
            eboxes[b, k] = (x0 + s // 2 + k % 2, y0 + s // 3 + k // 2,
                            9 + k % 3, 9 + k % 3)
        evalid[b, :6] = True
    face_raw = (fboxes, fvalid, np.zeros((2 * n, 64), np.int32),
                np.zeros(2 * n, np.int32))
    part_raw = {"ear": (eboxes, evalid, np.zeros(2 * n, bool))}
    pdet._face_raw, pdet._n_real = face_raw, n
    jdet._face_raw, jdet._n_real = tuple(jnp.asarray(a) for a in face_raw), n
    j_part = {"ear": tuple(jnp.asarray(a) for a in part_raw["ear"])}
    for b in range(n):
        got = pdet._process_frame(None, part_raw, b)
        assert got == jdet._process_frame(None, j_part, b)
        assert len(got["face_profile"]) == 6 and got["ear"]
