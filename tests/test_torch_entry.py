"""The port's entry point (``nubomedia_vca_tpu_torch/entry.py``) against
the JAX package's ``__graft_entry__.py`` on the CPU:

* ``entry(device="cpu")``'s fn on its example batch (4 frames of seeded
  640x480 noise) and on face frames equals the JAX ``entry()``'s fn
  (jitted): raw candidates exactly; the work images' dense phase against
  the JAX Pallas pyramid kernel in interpret mode, ``alive`` exactly and
  ``vnf`` within the per-window bound of ``tests/test_torch_dense_kernel.py``
  (XLA:CPU fuses the variance's subtraction into an FMA);
* the example batch is the JAX entry's, on the requested device; the
  default device is the card and raises here;
* ``dryrun_multichip(2, device="cpu")`` runs two gloo processes and
  prints the JAX dry run's one-line summary.
"""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.cascade.engine import CascadeEngine as JaxEngine
from nubomedia_vca_tpu.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu.ops.pallas.dense_pallas import (
    build_pyramid_dense_phase)
from nubomedia_vca_tpu_torch import entry
from nubomedia_vca_tpu_torch.ops.cuda import dense_cuda
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact
from nubomedia_vca_tpu_torch.utils.synth import face_clip

from .test_torch_dense_kernel import _norm_terms

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FACE_XML = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt.xml"


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX package's entry() → (jitted fn, example as numpy)."""
    if not os.path.exists(JAX_FACE_XML):
        pytest.skip(f"{JAX_FACE_XML} not installed (the JAX entry reads it)")
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, (example,) = mod.entry()
    return jax.jit(fn), np.asarray(example)


@pytest.fixture(scope="module")
def port_entry():
    return entry.entry(device="cpu")


def _inputs(example):
    return {"example": example,
            "faces": face_clip(entry.EXAMPLE_BATCH, *entry.FRAME, seed=3)}


def test_example_is_the_jax_entrys(jax_entry, port_entry):
    _, (example,) = port_entry
    assert example.device.type == "cpu" and example.dtype == torch.uint8
    assert tuple(example.shape) == (4, 480, 640)
    np.testing.assert_array_equal(example.numpy(), jax_entry[1])


@pytest.mark.parametrize("which", ["example", "faces"])
def test_raw_candidates_equal_jax(jax_entry, port_entry, which):
    fn, (example,) = port_entry
    gray = _inputs(example.numpy())[which]
    got = fn(torch.from_numpy(gray))
    want = jax_entry[0](jnp.asarray(gray))
    for g, w, name in zip(got, want, ("boxes", "valid", "overflow")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    if which == "faces":
        assert int(got[1].sum()) > 0, "the face frames give candidates"


def test_dense_phase_matches_pallas_kernel(port_entry):
    """The entry's work images through the port's pyramid dense phase
    (plain version) against the JAX Pallas kernel (interpret mode):
    level images and alive exactly, vnf within the per-window FMA bound."""
    _, (example,) = port_entry
    gray = np.concatenate([example.numpy()[:1], face_clip(1, *entry.FRAME,
                                                          seed=3)])
    work = equalize_hist(resize_linear_exact(torch.from_numpy(gray),
                                             entry.WORK))
    peng = entry.CascadeEngine(entry.load_cascade(entry.DEFAULT_FACE_CASCADE),
                               entry.WORK, entry.FACTOR, device="cpu")
    jeng = JaxEngine(load_cascade_xml(entry.DEFAULT_FACE_CASCADE), entry.WORK,
                     entry.FACTOR, use_pallas_dense=True,
                     use_pallas_pyramid=True)
    chunk = tuple(range(len(jeng.levels)))
    assert jeng._pyramid_chunks() == (chunk,)
    want = build_pyramid_dense_phase(jeng, chunk)(jnp.asarray(work.numpy()),
                                                  interpret=True)
    got = dense_cuda.pyramid_dense_phase_reference(work, peng._plan)
    assert len(got) == len(chunk)
    n_alive = 0
    for li, (img_l, vnf, alive) in enumerate(got):
        w_img, w_vnf, w_alive = want[li]
        assert (img_l is None) == (w_img is None), li
        if img_l is not None:
            np.testing.assert_array_equal(img_l.numpy(), np.asarray(w_img))
        np.testing.assert_array_equal(alive.numpy(),
                                      np.asarray(w_alive).astype(np.uint8))
        n_alive += int(alive.sum())
        vnf, w_vnf = vnf.numpy(), np.asarray(w_vnf)
        a, p = _norm_terms(work.numpy() if img_l is None else img_l.numpy(),
                           peng.levels[li], peng._tables)
        nf = a - p
        valid = nf > np.float32(peng._tables.var_thr)
        np.testing.assert_array_equal(vnf[~valid], w_vnf[~valid])
        a, p, nf = a[valid], p[valid], nf[valid]
        tol = ((np.spacing(a) + np.spacing(p)) / (2.0 * nf)
               + 4 * np.finfo(np.float32).eps)
        rel = (np.abs(vnf[valid].astype(np.float64) - w_vnf[valid])
               / w_vnf[valid])
        assert (rel <= tol).all(), (li, float((rel / tol).max()))
    assert n_alive > 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        entry.dryrun_multichip(1)


def test_dryrun_multichip_two_processes(capsys):
    reports = entry.dryrun_multichip(2, device="cpu")
    assert len(reports) == 2
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): train loss " in out and out.rstrip(
    ).endswith("OK")
    assert reports[0]["detect"][0].shape[0] == 4
