"""The port's multi-device layer (``parallel/``) against the port's
unsharded path and the JAX package's sharded functions, on the CPU.

One ``dryrun_multichip(4, device="cpu")`` runs 4 gloo processes on a
2 (data) x 2 (model) mesh at the JAX dry run's small shapes (64x48 frames;
CNN channels (8, 8, 8, 8) with the context conv, head width 32) and
returns each process's outputs. They are held to:

* sharded detection, grouped serving detection (4 streams through the
  ``StreamFeeder``) and the sharded part chain (frontalface_alt grouped +
  the tilted ``lefteye_2splits`` at factor 1.1, compacted): exactly the
  port's unsharded engine and the JAX package's ``make_sharded_detect*``
  on a 2x2 virtual mesh (as ``tests/test_misc.py`` builds them), on every
  process;
* the dp×tp train step, 2 steps at constant lr on one batch whose data
  shards hold different numbers of positive and ring cells: against the
  port's unsharded ``train_step`` within the card-vs-card bounds of the
  training path (losses 1e-5 relative; parameters max 2·Σ lr, median
  lr/1000: the TP head's all-reduce changes the float32 summation order of
  h @ W2 and each shard's bf16 weight gradients are summed in float32);
  against JAX's unsharded ``cnn.train_step`` within the torch-vs-XLA
  bounds of ``tests/test_torch_train.py`` (losses 1e-3 relative;
  parameters max 2·k·lr, median lr/20);
* the same train step on the recipe's warmup-cosine schedule
  (``steps=``), k steps, then resumed for k more from the gathered
  optimizer and scheduler state, against an uninterrupted unsharded run
  of the port and of JAX on that schedule, within the same bounds (the
  parameters' max within 2·Σ lr of the steps taken).
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nubomedia_vca_tpu.cascade.engine import CascadeEngine as JaxEngine
from nubomedia_vca_tpu.cascade.xml_loader import load_cascade_xml
from nubomedia_vca_tpu.models import cnn as jcnn
from nubomedia_vca_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nubomedia_vca_tpu.parallel.sharded import (
    make_sharded_chain as jax_chain, make_sharded_detect as jax_detect,
    make_sharded_detect_grouped as jax_grouped)
from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine, load_cascade
from nubomedia_vca_tpu_torch.cascade.paths import find_cascade
from nubomedia_vca_tpu_torch.models import cnn as pcnn
from nubomedia_vca_tpu_torch.parallel import dryrun, mesh as pmesh

from .fixtures import FACE_XML, LEFT_EYE_XML

torch.set_num_threads(2)

N = 4                          # 2 (data) x 2 (model)
LR = 3e-4
CARD_LOSS_RTOL = 1e-5          # sharded port vs unsharded port
CARD_PARAM_MEDIAN = LR / 1000
JAX_LOSS_RTOL = 1e-3           # sharded port vs unsharded JAX
JAX_PARAM_MEDIAN = LR / 20


@pytest.fixture(scope="module")
def run():
    """(inputs, per-rank reports) of one 4-process gloo dry run."""
    inputs = dryrun.small_inputs(N)
    return inputs, dryrun.dryrun_multichip(N, "cpu", inputs=inputs)


@pytest.fixture(scope="module")
def port_engines():
    face = CascadeEngine(load_cascade(find_cascade(
        "haarcascade_frontalface_alt.xml")), (64, 48), 1.25, device="cpu")
    eye = CascadeEngine(load_cascade(find_cascade(
        "haarcascade_lefteye_2splits.xml")), (64, 48), 1.1, device="cpu")
    return face, eye


@pytest.fixture(scope="module")
def jax_outputs(run):
    """The JAX package's sharded functions on a 2x2 virtual mesh, on the
    same inputs."""
    inputs, reports = run
    mesh = jax_make_mesh(n_data=2, n_model=2)
    face = JaxEngine(load_cascade_xml(FACE_XML), (64, 48), 1.25)
    eye = JaxEngine(load_cascade_xml(LEFT_EYE_XML), (64, 48), 1.1)
    out = {
        "detect": jax_detect(face, mesh)(jnp.asarray(inputs.face)),
        "serve": jax_grouped(face, mesh, 3)(
            jnp.asarray(reports[0]["serve_frames"])),
        "chain": jax_chain(face, {"eye_left": eye}, mesh, 3)(
            jnp.asarray(inputs.face), jnp.asarray(inputs.part)),
    }
    return jax.tree_util.tree_map(np.asarray, out)


def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=what)


def _torch_np(outputs):
    if isinstance(outputs, dict):
        return {k: _torch_np(v) for k, v in outputs.items()}
    return tuple(t.numpy() for t in outputs)


def test_every_rank_holds_the_whole_result(run):
    _, reports = run
    assert len(reports) == N
    for key in ("detect", "serve", "chain", "train_losses", "train_params",
                "schedule_losses", "schedule_params"):
        for r, rep in enumerate(reports[1:], 1):
            _assert_same(rep[key], reports[0][key], f"rank {r} {key}")
    assert all(rep["setup_s"] > 0 for rep in reports)
    # no card: every kernel ran its plain version, none launched
    assert not any(reports[0]["launches"].values())


def test_sharded_detect_equals_unsharded_and_jax(run, port_engines,
                                                 jax_outputs):
    inputs, reports = run
    face, _ = port_engines
    want = _torch_np(face._detect_impl(torch.from_numpy(inputs.face)))
    _assert_same(reports[0]["detect"], want, "port unsharded")
    _assert_same(reports[0]["detect"], jax_outputs["detect"], "jax sharded")
    assert reports[0]["detect"][0].shape[0] == 2 * N


def test_sharded_serving_step_equals_unsharded_and_jax(run, port_engines,
                                                       jax_outputs):
    """4 streams round robin through the feeder; the grouped [B, 64]
    outputs come back in global frame order."""
    inputs, reports = run
    rep = reports[0]
    np.testing.assert_array_equal(rep["serve_frames"], inputs.serve)
    assert sorted(set(rep["serve_streams"].tolist())) == [0, 1, 2, 3]
    face, _ = port_engines
    want = _torch_np(face._group_impl(
        *face._detect_impl(torch.from_numpy(inputs.serve)), min_neighbors=3))
    _assert_same(rep["serve"], want, "port unsharded")
    _assert_same(rep["serve"], jax_outputs["serve"], "jax sharded")
    assert rep["serve"][0].shape == (2 * N, 64, 4)


def test_sharded_chain_equals_unsharded_and_jax(run, port_engines,
                                                jax_outputs):
    inputs, reports = run
    face, eye = port_engines
    fg, pg = torch.from_numpy(inputs.face), torch.from_numpy(inputs.part)
    want = (_torch_np(face._group_impl(*face._detect_impl(fg),
                                       min_neighbors=3)),
            {"eye_left": _torch_np(eye._compact_raw_impl(
                *eye._detect_impl(pg)))})
    got = reports[0]["chain"]
    _assert_same(got, want, "port unsharded")
    _assert_same(got, jax_outputs["chain"], "jax sharded")
    assert eye._uses_tilt and got[1]["eye_left"][0].shape == (2 * N, 256, 4)


def _targets(inputs):
    _, h, w = inputs.train_gray.shape
    return pcnn.boxes_to_targets(torch.from_numpy(inputs.train_boxes),
                                 torch.from_numpy(inputs.train_valid), h, w)


def test_train_batch_shards_differ_in_ring_cells(run):
    """The batch the sharded step is held on: its two data shards hold
    different numbers of positive and ring cells, so a mean of per-shard
    losses would differ from the global loss."""
    inputs, _ = run
    obj, _ = _targets(inputs)
    regw = ((obj > 0) | (obj == -1)).float().sum(dim=(1, 2))
    shards = regw.reshape(2, -1).sum(dim=1)
    assert shards[0] != shards[1] and shards.min() > 0, shards


def test_sharded_train_step_equals_unsharded_port(run):
    inputs, reports = run
    gray = torch.from_numpy(inputs.train_gray)
    obj, reg = _targets(inputs)
    model = pcnn.CnnNet(inputs.params)
    opt, sched = pcnn.make_optimizer(model.parameters(), LR)
    want = [float(pcnn.train_step(model, opt, sched, gray, obj, reg)[0])
            for _ in range(inputs.train_steps)]
    got = reports[0]["train_losses"]
    for g, w in zip(got, want):
        assert abs(g - w) <= CARD_LOSS_RTOL * abs(w), (got, want)
    pmax, pmed = dryrun.params_gap(reports[0]["train_params"],
                                   pcnn.params_to_numpy(model.state_dict()))
    assert pmax <= 2 * LR * inputs.train_steps, pmax
    assert pmed <= CARD_PARAM_MEDIAN, pmed


def test_sharded_train_step_matches_jax(run):
    inputs, reports = run
    params = jax.tree_util.tree_map(jnp.asarray, inputs.params)
    obj, reg = _targets(inputs)
    opt = jcnn.make_optimizer()
    step = jax.jit(lambda p, o, g, ot, rt: jcnn.train_step(
        p, o, g, ot, rt, optimizer=opt))
    state = opt.init(params)
    gray = jnp.asarray(inputs.train_gray)
    want = []
    for _ in range(inputs.train_steps):
        params, state, loss = step(params, state, gray, obj.numpy(),
                                   reg.numpy())
        want.append(float(loss))
    got = reports[0]["train_losses"]
    for g, w in zip(got, want):
        assert abs(g - w) <= JAX_LOSS_RTOL * abs(w), (got, want)
    pmax, pmed = dryrun.params_gap(
        reports[0]["train_params"],
        jax.tree_util.tree_map(np.asarray, params))
    assert pmax <= 2 * LR * inputs.train_steps, pmax
    assert pmed <= JAX_PARAM_MEDIAN, pmed
    # the parameters moved
    assert not np.array_equal(reports[0]["train_params"]["head1"]["w"],
                              inputs.params["head1"]["w"])


def _sum_lr(n_steps, steps):
    factor = pcnn.warmup_cosine(steps)
    return LR * sum(factor(i) for i in range(n_steps))


def test_sharded_warmup_cosine_and_resume_equal_unsharded_port(run):
    """The recipe's warmup-cosine schedule (``steps=``): k sharded steps,
    the gathered optimizer and scheduler state saved and read back, a new
    sharded step resumed from it for k more, against one uninterrupted
    unsharded run of 2k steps on the same schedule."""
    inputs, reports = run
    k, n = inputs.train_steps, dryrun.SCHEDULE_STEPS
    gray = torch.from_numpy(inputs.train_gray)
    obj, reg = _targets(inputs)
    model = pcnn.CnnNet(inputs.params)
    opt, sched = pcnn.make_optimizer(model.parameters(), LR, n)
    want = [float(pcnn.train_step(model, opt, sched, gray, obj, reg)[0])
            for _ in range(2 * k)]
    got = reports[0]["schedule_losses"]
    assert len(got) == 2 * k
    for g, w in zip(got, want):
        assert abs(g - w) <= CARD_LOSS_RTOL * abs(w), (got, want)
    pmax, pmed = dryrun.params_gap(reports[0]["schedule_params"],
                                   pcnn.params_to_numpy(model.state_dict()))
    assert pmax <= 2 * _sum_lr(2 * k, n), pmax
    assert pmed <= CARD_PARAM_MEDIAN, pmed
    # the schedule moved the parameters, and away from the constant-lr run
    assert not np.array_equal(reports[0]["schedule_params"]["head1"]["w"],
                              inputs.params["head1"]["w"])
    assert reports[0]["schedule_check"]["lr_sum"] == pytest.approx(
        _sum_lr(2 * k, n))


def test_sharded_warmup_cosine_and_resume_match_jax(run):
    """The same sharded run against JAX's unsharded ``cnn.train_step``
    with ``cnn.make_optimizer(steps=n)`` (optax's warmup-cosine)."""
    inputs, reports = run
    k, n = inputs.train_steps, dryrun.SCHEDULE_STEPS
    params = jax.tree_util.tree_map(jnp.asarray, inputs.params)
    obj, reg = _targets(inputs)
    opt = jcnn.make_optimizer(steps=n)
    step = jax.jit(lambda p, o, g, ot, rt: jcnn.train_step(
        p, o, g, ot, rt, optimizer=opt))
    state = opt.init(params)
    gray = jnp.asarray(inputs.train_gray)
    want = []
    for _ in range(2 * k):
        params, state, loss = step(params, state, gray, obj.numpy(),
                                   reg.numpy())
        want.append(float(loss))
    got = reports[0]["schedule_losses"]
    for g, w in zip(got, want):
        assert abs(g - w) <= JAX_LOSS_RTOL * abs(w), (got, want)
    pmax, pmed = dryrun.params_gap(
        reports[0]["schedule_params"],
        jax.tree_util.tree_map(np.asarray, params))
    assert pmax <= 2 * _sum_lr(2 * k, n), pmax
    assert pmed <= JAX_PARAM_MEDIAN, pmed


def test_cnn_param_shardings_split_the_head_on_model():
    from torch.distributed.tensor import Replicate, Shard

    params = pcnn.init_params(torch.Generator().manual_seed(0),
                              channels=(8, 8, 8, 8), head_dim=32, ctx=True)
    sh = pmesh.cnn_param_shardings(None, params)
    assert sorted(sh) == sorted(params)
    assert sh["head1"]["w"] == (Replicate(), Shard(1))
    assert sh["head1"]["b"] == (Replicate(), Shard(0))
    assert sh["head2"]["w"] == (Replicate(), Shard(0))
    for name in ("conv0", "conv3", "ctx", "head2"):
        assert sh[name]["b"] == (Replicate(), Replicate())
    assert sh["ctx"]["w"] == (Replicate(), Replicate())


def test_init_distributed_one_process_group(tmp_path):
    pmesh.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0, "cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
        m = pmesh.make_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (1, 1)
        frames = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
        np.testing.assert_array_equal(
            pmesh.shard_frames(m, frames).numpy(), frames)
        with pytest.raises(ValueError):
            pmesh.make_mesh(2, 1, "cpu")
    finally:
        dist.destroy_process_group()
    pmesh.init_distributed(None)          # no coordinator: a no-op
    assert not dist.is_initialized()


def test_cuda_requests_raise_without_cards():
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.dryrun_multichip(1)                    # the default: cards
    with pytest.raises(RuntimeError, match="cuda"):
        pmesh.init_distributed("tcp://127.0.0.1:1", 1, 0, "cuda")
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1), \
            mock.patch.object(torch.cuda, "current_device", return_value=0):
        with pytest.raises(ValueError, match="2 cards"):
            dryrun.dryrun_multichip(2, "cuda")
