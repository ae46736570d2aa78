"""The port's tools and examples (``tools/torch_*.py``,
``examples/torch_*.py``) against the JAX package's on the CPU:

* ``torch_eval_trained_cascades``: ``real_fp_scan`` of each shipped
  trained cascade and the bundled profile cascade on a ``utils/synth``
  frame and, where installed, the Grace Hopper portrait, and
  ``eval_xml_windows`` on cv2-free windows, equal to the JAX tool's
  (imported by path, as ``tests/test_real_fp_sweep.py`` does);
* ``torch_real_eval.evaluate(..., quantized=True)``: the JAX tool's tp,
  fn and fp on the same synthetic frames, passed as ``.npy`` files;
* ``torch_make_cnn_eval_labels``: the frozen ``tests/data/
  cnn_eval_labels.npz`` (boxes, valid, ignore, ignore_valid) exactly,
  written to a temporary path;
* ``torch_train_part_cascades.train_one`` at a reduced config with
  injected cv2-free samplers: the JAX trainer's XML bytes at that config;
  a holdout under 0.9 writes nothing;
* each demo once as a subprocess on the CPU at a tiny frame count (rc 0);
  without ``--device cpu`` a demo asks for the card and fails here.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.cascade import train as jtrain
from nubomedia_vca_tpu.cascade.xml_loader import (load_cascade_xml as
                                                  jax_load_cascade_xml)
from nubomedia_vca_tpu_torch.cascade import train
from nubomedia_vca_tpu_torch.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu_torch.models.face import FaceDetector
from nubomedia_vca_tpu_torch.utils.offline_images import offline_photos
from nubomedia_vca_tpu_torch.utils.synth import face_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
# the cascade trainer's reduced config (tests/test_torch_tooling.py's, at
# the recipe's 20x20 window, which the cv2-free samplers draw)
TINY = dict(window=(20, 20), n_stages=2, n_pos=300, n_neg=600,
            max_features=400, max_weaks_per_stage=10, verbose=False)
# the size of the portrait, so that the JAX engines built for one serve
# the other (each costs seconds of XLA compile)
PHOTO_W, PHOTO_H = 512, 600


def _load(name: str, filename: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    """(port tool, JAX tool) modules by name."""
    return {n: (_load(f"port_{n}", f"torch_{n}.py"), _load(f"jax_{n}",
                                                          f"{n}.py"))
            for n in ("eval_trained_cascades", "real_eval")}


def _samplers(window=(20, 20)):
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke.tooling_samplers(window)


# ------------------------------------------------- eval_trained_cascades
@pytest.fixture(scope="module")
def scan_frames():
    """{name: (gray, face box or None)}: a synthetic frame at the
    portrait's size, and the portrait where installed, with the port's
    face box on it."""
    frames = {"synth": (face_scene(PHOTO_W, PHOTO_H,
                                   faces=((250, 300, 150),), seed=4), None)}
    photos = offline_photos(faces=True)
    if photos:
        port = _load("port_eval_photo", "torch_eval_trained_cascades.py")
        gray = port.photo_gray(photos[0].bgr)
        assert gray.shape == (PHOTO_H, PHOTO_W)
        f = FaceDetector((PHOTO_W, PHOTO_H), device="cpu").process(
            gray[None])[0][0]
        frames["portrait"] = (gray, (f.x, f.y, f.w, f.h))
    return frames


@pytest.mark.parametrize("cascade", ["vca_nose", "vca_ear",
                                     "vca_profileface",
                                     "haarcascade_profileface"])
def test_real_fp_scan_equals_jax(tools, scan_frames, cascade):
    port, jax_tool = tools["eval_trained_cascades"]
    scans = {n: (p, fam) for n, p, fam in port.sweep_scans()}
    path, family = scans[cascade]
    jpath = os.path.join(jax_tool.ASSETS, os.path.basename(path))
    if cascade == "haarcascade_profileface":
        jpath = jax_tool.REAL_PROFILE
        if not os.path.exists(jpath):
            pytest.skip(f"{jpath} not installed")
    assert open(path, "rb").read() == open(jpath, "rb").read()
    for name, (gray, face_box) in scan_frames.items():
        got = port.real_fp_scan(path, gray, family, face_box, device="cpu")
        want = jax_tool.real_fp_scan(jpath, gray, family, face_box)
        assert got == want, name


def test_eval_xml_windows_equals_jax(tools):
    port, jax_tool = tools["eval_trained_cascades"]
    pos_s, neg_s = _samplers()
    rng = np.random.RandomState(3)
    wins = np.concatenate([pos_s(300, rng), neg_s(900, rng)])
    wins = wins[train.vnf_and_valid(wins)[1]]
    n_pass = 0
    for fname in port.PARTS.values():
        got = port.eval_xml_windows(
            load_cascade_xml(os.path.join(port.ASSETS, fname)), wins,
            device="cpu")
        want = jax_tool.eval_xml_windows(
            jax_load_cascade_xml(os.path.join(jax_tool.ASSETS, fname)), wins)
        np.testing.assert_array_equal(got, want, err_msg=fname)
        n_pass += int(got.sum())
    assert 0 < n_pass < 3 * len(wins)


def test_real_sweep_rows_on_a_given_photo(tools):
    port, _ = tools["eval_trained_cascades"]
    photo = mock.Mock(bgr=np.repeat(face_scene(320, 240, faces=(
        (160, 120, 75),), seed=2)[..., None], 3, axis=2), n_faces=1)
    photo.name = "synth"
    rows = port.run_real_sweep("cpu", photos=[photo])
    assert [r["cascade"] for r in rows] == [n for n, _, _ in
                                            port.sweep_scans()]
    assert rows[0]["face_box"] is not None
    assert all(r["n_det"] == r["n_in_face"] + r["n_fp"] for r in rows)


# ------------------------------------------------------------ real_eval
def test_real_eval_int8_matches_jax(tools, tmp_path):
    port, jax_tool = tools["real_eval"]
    images = []
    for i, faces in enumerate((((200, 240, 120),),
                               ((160, 200, 110), (480, 280, 100)),
                               ((320, 240, 60),))):
        path = str(tmp_path / f"scene_{i}.npy")
        np.save(path, face_scene(640, 480, faces=faces, seed=i))
        images.append((path, path))
    record = []
    got = port.evaluate(images, quantized=True, device="cpu", record=record)
    want = jax_tool.evaluate([(p, np.load(p)) for p, _ in images],
                             quantized=True)
    assert got[2:] == want[2:]
    assert got[:2] == want[:2]
    assert got[2] >= 1 and len(record) == len(images)


def test_load_gray_without_cv2(tools, tmp_path):
    port, _ = tools["real_eval"]
    bgr = np.random.RandomState(0).randint(0, 256, (6, 5, 3), np.uint8)
    path = str(tmp_path / "photo.npy")
    np.save(path, bgr)
    cv2 = pytest.importorskip("cv2")
    want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    with mock.patch.dict(sys.modules, {"cv2": None}):
        np.testing.assert_array_equal(port._load_gray(path), want)
        np.testing.assert_array_equal(port._load_gray(bgr), want)
        with pytest.raises(ImportError, match="cv2"):
            port._load_gray(str(tmp_path / "photo.jpg"))


# ------------------------------------------------- make_cnn_eval_labels
def test_make_cnn_eval_labels_reproduces_the_frozen_file(tmp_path):
    tool = _load("port_labels", "torch_make_cnn_eval_labels.py")
    frozen = np.load(tool.FROZEN)
    out = str(tmp_path / "labels.npz")
    assert tool.main(["--out", out, "--device", "cpu",
                      "--seed", str(int(frozen["seed"])),
                      "--n", str(int(frozen["n"]))]) == 0
    got = np.load(out)
    for key in ("seed", "n", "boxes", "valid", "ignore", "ignore_valid"):
        np.testing.assert_array_equal(got[key], frozen[key], err_msg=key)
    assert frozen["valid"].sum() > 0
    with pytest.raises(SystemExit):
        tool.main(["--out", tool.FROZEN, "--device", "cpu"])


# ----------------------------------------------------- train_part_cascades
def test_train_one_writes_the_jax_trainers_bytes(tmp_path):
    tool = _load("port_train", "torch_train_part_cascades.py")
    pos_s, neg_s = _samplers(TINY["window"])
    out = str(tmp_path / "port.xml")
    res = tool.train_one("nose", out, device="cpu",
                         cfg=train.TrainConfig(**TINY),
                         samplers=(pos_s, neg_s, {"clean": neg_s}))
    assert res["det"] >= tool.MIN_HOLDOUT_DET
    jout = str(tmp_path / "jax.xml")
    jtrain.write_cascade_xml(jout, jtrain.train_cascade(
        pos_s, neg_s, jtrain.TrainConfig(**TINY)))
    assert open(out, "rb").read() == open(jout, "rb").read()
    assert tool.SPECS == _load("jax_train", "train_part_cascades.py").SPECS


def test_train_one_refuses_a_low_holdout(tmp_path):
    tool = _load("port_train_low", "torch_train_part_cascades.py")
    pos_s, neg_s = _samplers(TINY["window"])
    out = tmp_path / "never.xml"
    with mock.patch.object(tool, "MIN_HOLDOUT_DET", 1.01):
        with pytest.raises(SystemExit, match="not shipping"):
            tool.train_one("nose", str(out), device="cpu",
                           cfg=train.TrainConfig(**TINY),
                           samplers=(pos_s, neg_s, {}))
    assert not out.exists()


# ------------------------------------------------------------- examples
EXAMPLES = {"torch_annotated_stream_demo.py": ("--frames", "3"),
            "torch_cnn_demo.py": ("--frames", "2", "--quantized"),
            "torch_full_chain_demo.py": ("--frames", "2"),
            "torch_rpc_client_demo.py": (),
            "torch_serving_demo.py": ("--streams", "2", "--frames", "3")}


def _run_example(name, args, tmp_path, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               NUBOMEDIA_VCA_KERNEL_DIR=str(tmp_path / "kernels"))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    out = _run_example(name, ("--device", "cpu", *EXAMPLES[name]), tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.strip()


def test_example_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = _run_example("torch_full_chain_demo.py", ("--frames", "1"),
                       tmp_path)
    assert out.returncode != 0
    assert "cuda" in out.stderr
