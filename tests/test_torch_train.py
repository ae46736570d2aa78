"""The learned detectors' training path in the port (``models/cnn.py``'s
training half, ``models/distill.py``, ``models/cnn_parts.py``'s training
half) against the JAX package on the CPU, from the same numpy inputs.

* ``boxes_to_targets`` and ``cnn_parts.targets`` equal the jitted JAX
  functions bit for bit (duplicate cells, zero-padded boxes colliding with
  a valid one, ignore boxes included); ``make_scene``,
  ``scene_with_parts`` and ``label_batch`` equal the JAX package's.
* ``loss_fn`` within 2e-5 relative. Gradients within a share of each
  leaf's largest |gradient|: 1.5e-2 for weights and the head's biases.
  A conv bias's gradient is the sum of its conv output's bf16 cotangent
  over the batch and the grid. XLA:CPU's sum strays from the float32 sum
  of that same cotangent by up to 0.27 of the leaf's max at the shipped
  width (B=2); the port sums in float32 and rounds once, and lies within
  3.1e-3 of it in every case here. So conv biases are held within 1e-2 to
  the float32 sum of JAX's cotangent (``_conv_bias_grads``).
* 3 train steps from carried weights: losses within 1e-3 relative;
  parameters within 2·k·lr absolute (Adam's first updates are ±lr whatever
  the gradient's size, so a near-zero gradient of the other sign moves an
  element 2·lr apart) and their median difference under lr / 20.
* the lr at every count within 1e-6 of the peak lr and 1e-5 relative of
  optax's: optax evaluates the schedule in float32, and its own eager and
  jitted values differ by up to 8.5e-6 relative.
"""

from __future__ import annotations

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nubomedia_vca_tpu.models import cnn as jcnn
from nubomedia_vca_tpu.models import cnn_parts as jparts
from nubomedia_vca_tpu.models import distill as jdistill
from nubomedia_vca_tpu_torch.models import cnn as pcnn
from nubomedia_vca_tpu_torch.models import cnn_parts as pparts
from nubomedia_vca_tpu_torch.models import distill as pdistill

torch.set_num_threads(2)

SMALL = {"channels": (8, 8, 8, 8), "head_dim": 16}
LR = 3e-4
LOSS_RTOL = 2e-5
W_GRAD_TOL = 1.5e-2
B_GRAD_TOL = 1e-2
STEP_LOSS_RTOL = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ init
@pytest.mark.parametrize("kind", ["face", "face_ctx", "parts"])
def test_init_params_keys_shapes_scales(kind):
    if kind == "parts":
        want = _np(jparts.init_params(jax.random.PRNGKey(0)))
        got = pparts.init_params(torch.Generator().manual_seed(0))
    else:
        ctx = kind == "face_ctx"
        want = _np(jcnn.init_params(jax.random.PRNGKey(0), ctx=ctx))
        got = pcnn.init_params(torch.Generator().manual_seed(0), ctx=ctx)
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == ["b", "w"]
        for leaf in ("w", "b"):
            assert got[name][leaf].shape == want[name][leaf].shape
            assert got[name][leaf].dtype == np.float32
        assert not got[name]["b"].any() and not want[name]["b"].any()
        w = want[name]["w"]
        fan_in = int(np.prod(w.shape[:-1]))
        scale = 0.01 if name == "head2" else np.sqrt(2.0 / fan_in)
        n = w.size
        for params in (got, want):     # both draw N(0, scale²)
            a = params[name]["w"]
            assert abs(a.std() / scale - 1) < 4 / np.sqrt(2 * n), name
            assert abs(a.mean()) < 4 * scale / np.sqrt(n), name
    # the generator sets the draws
    def conv1(seed):
        return pcnn.init_params(torch.Generator().manual_seed(seed))[
            "conv1"]["w"]
    assert np.array_equal(conv1(0), conv1(0))
    assert not np.array_equal(conv1(0), conv1(1))


# --------------------------------------------------------------- targets
def _target_case(case, rs):
    """(boxes [B,N,4], valid [B,N], ignore boxes, ignore valid, (H, W))."""
    H, W = (64, 64) if case == "small" else (240, 320)
    B, N = 3, 6
    b = np.zeros((B, N, 4), np.float32)
    b[..., 0] = rs.randint(-20, W, (B, N))
    b[..., 1] = rs.randint(-20, H, (B, N))
    b[..., 2:] = rs.randint(1, min(H, 150), (B, N, 2))
    v = rs.rand(B, N) < 0.7
    ib = np.zeros_like(b)
    iv = np.zeros_like(v)
    if case in ("random", "small"):
        b += rs.uniform(0, 1, b.shape).astype(np.float32)
    elif case == "duplicates":         # three boxes centred in one cell
        b[:, 1:4] = b[:, :1] + rs.uniform(0, 3, (B, 3, 4)).astype(np.float32)
        v[:, :4] = True
        v[0, 2] = False                # an invalid box among them
    elif case == "padded_origin":      # a face near the corner + padding
        b[:, 0] = (6.0, 4.0, 30.0, 34.0)
        b[:, 1:] = 0.0
        v[:] = False
        v[:, 0] = True
    elif case == "ignore":
        ib = b[:, ::-1].copy() + 5.0
        iv = rs.rand(B, N) < 0.5
    return b, v, ib, iv, (H, W)


@pytest.mark.parametrize("case", ["random", "small", "duplicates",
                                  "padded_origin", "ignore"])
def test_boxes_to_targets_equals_jax(case):
    rs = np.random.RandomState(3)
    for _ in range(4):
        b, v, ib, iv, (H, W) = _target_case(case, rs)
        want_obj, want_reg = map(np.asarray, jax.jit(
            lambda *a: jcnn.boxes_to_targets(*a[:2], H, W, *a[2:]))(
                b, v, ib, iv))
        obj, reg = pcnn.boxes_to_targets(_t(b), _t(v), H, W, _t(ib), _t(iv))
        assert obj.dtype == reg.dtype == torch.float32
        np.testing.assert_array_equal(obj.numpy(), want_obj)
        np.testing.assert_array_equal(reg.numpy(), want_reg)
    if case == "padded_origin":
        # inherited: the padding boxes write cell (0, 0)'s old value back
        # after the face's (-1, -1) neighbour wrote it, so that ring cell
        # is regression-supervised towards 0
        assert (obj[:, 0, 0] == -1).all() and not reg[:, 0, 0].any()
    if case == "ignore":
        assert (obj == -2).any()


def test_xla_log_equals_jax():
    x = np.concatenate([np.arange(1, 4096, dtype=np.float32) / 16,
                        np.random.RandomState(0).uniform(
                            0.0625, 500, 20000).astype(np.float32)])
    want = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal(pcnn._xla_log(_t(x)).numpy(), want)
    # torch's own log is correctly rounded and differs from XLA's here
    assert (torch.log(_t(x)).numpy() != want).any()


def test_parts_targets_equal_jax():
    rs = np.random.RandomState(5)
    B, C, N = 3, pparts.C, pparts.MAX_PER_CLASS
    boxes = np.zeros((B, C, N, 4), np.float32)
    boxes[..., :2] = rs.randint(0, 300, (B, C, N, 2))
    boxes[..., 2:] = rs.randint(4, 120, (B, C, N, 2))
    boxes[:, :, 1] = boxes[:, :, 0]      # a duplicate cell in every class
    valid = rs.rand(B, C, N) < 0.6
    want = [np.asarray(a) for a in jax.jit(jparts.targets)(boxes, valid)]
    got = pparts.targets(_t(boxes), _t(valid))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------------ loss, grads
def _batch(kind, rs, B=2):
    """(params (JAX), gray, obj_t, reg_t, JAX loss_fn, port loss_fn): a
    batch of noise with random boxes' targets."""
    if kind == "parts":
        params = jparts.init_params(jax.random.PRNGKey(1), head_dim=16)
        H, W = 240, 320
    else:
        shipped = kind == "shipped"
        params = jcnn.init_params(jax.random.PRNGKey(1),
                                  **({} if shipped else SMALL),
                                  ctx=kind != "face")
        H, W = (240, 320) if shipped else (64, 64)
    gray = rs.randint(0, 256, (B, H, W)).astype(np.uint8)
    if kind == "parts":
        boxes = np.zeros((B, pparts.C, 3, 4), np.float32)
        boxes[..., :2] = rs.randint(0, 200, (B, pparts.C, 3, 2))
        boxes[..., 2:] = rs.randint(12, 90, (B, pparts.C, 3, 2))
        valid = rs.rand(B, pparts.C, 3) < 0.6
        obj, reg = jax.jit(jparts.targets)(boxes, valid)
        return params, gray, obj, reg, jparts.loss_fn, pparts.loss_fn
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[..., :2] = rs.randint(0, min(H, W) - 24, (B, 4, 2))
    boxes[..., 2:] = rs.randint(16, 40, (B, 4, 2))
    valid = rs.rand(B, 4) < 0.7
    obj, reg = jax.jit(lambda b, v: jcnn.boxes_to_targets(b, v, H, W))(
        boxes, valid)
    return params, gray, obj, reg, jcnn.loss_fn, pcnn.loss_fn


def _conv_bias_grads(jloss, params, gray, obj, reg) -> dict:
    """The conv biases' gradients from JAX's own cotangents, summed in
    float32: each conv output of the JAX forward gets a zero addend, the
    loss's gradient with respect to the addends is that output's bf16
    cotangent, and a bias's gradient is its sum over batch and grid."""
    real = jax.lax.conv_general_dilated
    outs = []

    def record(*a, **k):
        outs.append(real(*a, **k))
        return outs[-1]

    with mock.patch.object(jax.lax, "conv_general_dilated", record):
        jax.eval_shape(lambda p: jloss(p, gray, obj, reg)[0], params)

    def loss_of(addends):
        it = iter(addends)
        with mock.patch.object(jax.lax, "conv_general_dilated",
                               lambda *a, **k: real(*a, **k) + next(it)):
            return jloss(params, gray, obj, reg)[0]

    cots = jax.jit(jax.grad(loss_of))(
        [jnp.zeros(o.shape, o.dtype) for o in outs])
    names = [f"conv{i}" for i in range(4)] + ["ctx"] * ("ctx" in params)
    assert len(cots) == len(names)
    return {n: np.asarray(c).astype(np.float32).sum(axis=(0, 1, 2))
            for n, c in zip(names, cots)}


@pytest.mark.parametrize("kind", ["face", "face_ctx", "parts", "shipped"])
def test_loss_and_grads_match_jax(kind):
    params, gray, obj, reg, jloss, ploss = _batch(
        kind, np.random.RandomState(7))
    (want, (wo, wr)), grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params, jnp.asarray(gray), obj, reg)
    bias_ref = _conv_bias_grads(jloss, params, jnp.asarray(gray), obj, reg)
    model = pcnn.CnnNet(_np(params))
    got, (go, gr) = ploss(model, _t(gray), _t(obj), _t(reg))
    got.backward()
    for g, w in ((got.detach(), want), (go.detach(), wo), (gr.detach(), wr)):
        assert abs(float(g) - float(w)) <= LOSS_RTOL * abs(float(w))
    pgrads = pcnn.params_to_numpy(
        {k: p.grad for k, p in model.named_parameters()})
    for name, layer in _np(grads).items():
        for leaf, w in layer.items():
            tol = W_GRAD_TOL
            if leaf == "b" and name in bias_ref:
                w, tol = bias_ref[name], B_GRAD_TOL
            err = np.abs(pgrads[name][leaf] - w).max()
            assert err <= tol * np.abs(w).max(), (name, leaf, err)


def _dtype_copies(model, gray) -> int:
    """aten::_to_copy calls in one forward under no_grad."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(gray)
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::_to_copy")


def test_serving_forward_equals_training_forward():
    gray = _t(np.random.RandomState(2).randint(0, 256, (2, 240, 320),
                                               dtype=np.uint8))
    for params in (pcnn.init_params(torch.Generator().manual_seed(3),
                                    ctx=True),
                   pparts.init_params(torch.Generator().manual_seed(3))):
        net = pcnn.CnnNet(params)
        with torch.no_grad():
            train_out = net(gray)
        face = pcnn.CnnFace(params)
        serve = face(gray)
        assert not serve.requires_grad
        assert torch.equal(train_out, serve)
        # the serving model holds its weights as the forward casts them,
        # so it launches none of the training forward's weight casts (two
        # per conv layer, two per head layer)
        n_conv = len(pcnn._conv_layers(params))
        assert _dtype_copies(net, gray) - _dtype_copies(face, gray) \
            == 2 * n_conv + 4
        if params["head2"]["w"].shape[1] == 5:
            det = pcnn.CnnFaceDetector((320, 240), params=params,
                                       device="cpu")
        else:
            det = pparts.CnnPartDetector((320, 240), params=params,
                                         device="cpu")
            train_out = train_out.reshape(*train_out.shape[:3], pparts.C, 5)
        assert torch.equal(det.model(gray), train_out)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("steps", [2, 20, 50, 1500, None])
def test_lr_schedule_matches_optax(steps):
    model = pcnn.CnnNet(pcnn.init_params(torch.Generator().manual_seed(0),
                                         **SMALL))
    opt, sched = pcnn.make_optimizer(model.parameters(), LR, steps=steps)
    n = (steps or 30) + 5
    got = []
    for _ in range(n):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    if steps is None:
        assert got == [LR] * n
        return
    sched_j = optax.warmup_cosine_decay_schedule(
        0.0, LR, min(200, max(steps // 10, 1)), steps, LR * 0.02)
    want = np.array([float(sched_j(k)) for k in range(n)])
    got = np.array(got)
    assert got[0] == want[0] == 0.0
    assert np.abs(got - want).max() <= 1e-6 * LR
    nz = want != 0
    assert (np.abs(got - want)[nz] / want[nz]).max() <= 1e-5


def test_make_optimizer_rejects_a_schedule_with_no_decay():
    model = pcnn.CnnNet(pcnn.init_params(torch.Generator().manual_seed(0),
                                         **SMALL))
    with pytest.raises(ValueError):
        pcnn.make_optimizer(model.parameters(), LR, steps=1)
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, LR, 1, 1, LR * 0.02)


@pytest.mark.parametrize("kind", ["face_ctx", "shipped", "parts"])
def test_train_steps_match_jax(kind):
    """3 steps from carried weights on the warmup-cosine schedule (the
    parts trainer's constant lr for parts), 3 batches."""
    rs = np.random.RandomState(11)
    batches = [_batch(kind, rs) for _ in range(3)]
    params = batches[0][0]
    jloss, ploss = batches[0][4], batches[0][5]
    steps = None if kind == "parts" else 20
    jopt = jcnn.make_optimizer(LR, steps=steps)

    @jax.jit
    def jstep(p, o, g, ot, rt):
        (loss, _), grads = jax.value_and_grad(jloss, has_aux=True)(
            p, g, ot, rt)
        updates, o = jopt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    jp, jo = params, jopt.init(params)
    model = pcnn.CnnNet(_np(params))
    opt, sched = pcnn.make_optimizer(model.parameters(), LR, steps=steps)
    for k, (_, gray, obj, reg, _, _) in enumerate(batches):
        jp, jo, want = jstep(jp, jo, jnp.asarray(gray), obj, reg)
        got, _ = pcnn.train_step(model, opt, sched, _t(gray), _t(obj),
                                 _t(reg), loss=ploss)
        assert abs(float(got) - float(want)) <= STEP_LOSS_RTOL * abs(
            float(want)), k
    got_p = pcnn.params_to_numpy(model.state_dict())
    diffs = []
    for name, layer in _np(jp).items():
        for leaf, w in layer.items():
            d = np.abs(got_p[name][leaf] - w)
            assert d.max() <= 2 * 3 * LR, (name, leaf, d.max())
            diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) < LR / 20
    # the parameters moved (the schedule's count 0 moves nothing)
    init = _np(params)
    assert not np.array_equal(got_p["conv0"]["w"], init["conv0"]["w"])


def test_first_scheduled_step_moves_nothing():
    params = pcnn.init_params(torch.Generator().manual_seed(4), **SMALL)
    model = pcnn.CnnNet(params)
    opt, sched = pcnn.make_optimizer(model.parameters(), LR, steps=20)
    _, gray, obj, reg, _, _ = _batch("face", np.random.RandomState(1))
    pcnn.train_step(model, opt, sched, _t(gray), _t(obj), _t(reg))
    after = pcnn.params_to_numpy(model.state_dict())
    for name in params:
        for leaf in ("w", "b"):
            assert np.array_equal(after[name][leaf], params[name][leaf])


# ----------------------------------------------------------- checkpoints
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_params_npz_crosses_packages(tmp_path, direction):
    path = str(tmp_path / "ckpt.npz")
    if direction == "port_to_jax":
        model = pcnn.CnnNet(pcnn.init_params(
            torch.Generator().manual_seed(5), ctx=True))
        params = pcnn.params_to_numpy(model.state_dict())
        pcnn.save_params_npz(path, params)
        loaded = _np(jcnn.load_params_npz(path))
    else:
        params = _np(jcnn.init_params(jax.random.PRNGKey(5), ctx=True))
        jcnn.save_params_npz(path, params)
        loaded = pcnn.load_params_npz(path)
        # and back through the module's flat layout
        back = pcnn.params_to_numpy(pcnn.CnnNet(loaded).state_dict())
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, back, params))
    assert sorted(loaded) == sorted(params)
    for name in params:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(loaded[name][leaf],
                                          params[name][leaf])
    det = pcnn.CnnFaceDetector((640, 480), checkpoint=path, device="cpu")
    frames = np.random.RandomState(0).randint(0, 256, (2, 480, 640),
                                              dtype=np.uint8)
    assert len(det.process(frames)) == 2


# ------------------------------------------------------------- distill
def test_make_scene_equals_jax():
    for seed in (0, 1):
        got_rng, want_rng = (np.random.RandomState(seed) for _ in range(2))
        for _ in range(3):
            img, geom = pdistill.make_scene(got_rng, return_geom=True)
            wimg, wgeom = jdistill.make_scene(want_rng, return_geom=True)
            assert img.dtype == np.uint8 and img.shape == (240, 320)
            np.testing.assert_array_equal(img, wimg)
            assert geom == wgeom
        assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)


def test_scene_with_parts_equals_jax():
    got_rng, want_rng = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(3):
        for g, w in zip(pparts.scene_with_parts(got_rng),
                        jparts.scene_with_parts(want_rng)):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def teachers():
    """The JAX teacher (one XLA compile at 320x240) and the port's CPU
    teacher, once per file."""
    return jdistill.make_teacher(), pdistill.make_teacher("cpu")


def test_label_batch_equals_jax(teachers):
    jt, pt = teachers
    rng = np.random.RandomState(21)
    pairs = [pdistill.make_scene(rng, return_geom=True) for _ in range(8)]
    scenes = np.stack([p[0] for p in pairs])
    geoms = [p[1] for p in pairs]
    want = jdistill.label_batch(jt, scenes, geoms)
    got = pdistill.label_batch(pt, scenes, geoms)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 0                  # the teacher fires
    assert pdistill.label_batch(pt, scenes)[0].shape == (8, 4, 4)


def test_distill_trains_on_cpu(teachers, tmp_path, capsys):
    out = str(tmp_path / "student.npz")
    params, final = pdistill.train(steps=2, batch=2, n_pool=1, log_every=1,
                                   out=out, device="cpu")
    log = capsys.readouterr().out
    assert "step 1: loss" in log and f"saved {out}" in log
    assert np.isfinite(final)
    assert "ctx" in params and params["head1"]["w"].shape == (128, 256)
    init = pcnn.init_params(torch.Generator().manual_seed(0), ctx=True)
    assert not np.array_equal(params["conv0"]["w"], init["conv0"]["w"])
    det = pcnn.CnnFaceDetector((320, 240), checkpoint=out, device="cpu")
    scenes = np.stack([pdistill.make_scene(np.random.RandomState(s))
                       for s in range(2)])
    assert len(det.process(scenes)) == 2
    recall, precision = pdistill.evaluate(params, n_scenes=2, device="cpu")
    assert 0.0 <= recall <= 1.0 and 0.0 <= precision <= 1.0


def test_distill_command_line(monkeypatch):
    calls = []
    monkeypatch.setattr(pdistill, "train", lambda *a, **k: (
        calls.append((a, k)), ({}, 0.0))[1])
    assert pdistill.main(["--steps", "7", "--batch", "3", "--device", "cpu",
                          "--out", "x.npz"]) == 0
    (args, kw), = calls
    assert args[:2] == (7, 3) and kw["device"] == "cpu"
    assert kw["out"] == "x.npz"


def test_parts_trains_and_fine_tunes_on_cpu(tmp_path):
    out = str(tmp_path / "parts.npz")
    params, final = pparts.train(steps=2, batch=2, n_pool=1, out=out,
                                 log_every=1, device="cpu")
    assert np.isfinite(final) and os.path.exists(out)
    assert params["head2"]["w"].shape == (256, pparts.C * 5)
    # fine-tuning from the shipped checkpoint: a constant lr moves the
    # weights at the first step
    ckpt = pcnn.find_checkpoint(pparts.DEFAULT_CHECKPOINT)
    tuned, _ = pparts.train(steps=1, batch=2, n_pool=1, init=ckpt,
                            device="cpu")
    shipped = pcnn.load_params_npz(ckpt)
    assert not np.array_equal(tuned["ctx"]["w"], shipped["ctx"]["w"])
    assert np.abs(tuned["ctx"]["w"] - shipped["ctx"]["w"]).max() <= 2 * LR
    stats = pparts.evaluate(tuned, n_scenes=2, device="cpu")
    assert sorted(stats) == sorted(pparts.CLASSES)
