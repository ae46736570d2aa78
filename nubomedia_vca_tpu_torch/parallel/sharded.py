"""Sharded execution: multi-device detection and training steps — the
port of ``nubomedia_vca_tpu/parallel/sharded.py`` over ``torch.distributed``.

Detection: every process takes its shard (on ``data``) of the frame
batch (many streams), runs the cascade engine's own device program on it
(``_detect_impl``, then ``_group_impl`` or ``_compact_raw_impl``), and the
per-shard results are all-gathered over ``data`` in rank order, so every
process holds the whole batch's result (SURVEY.md §2.5 — "all-gather of
per-shard detections"), equal to the unsharded engine's.

Training (learned detector): data-parallel over ``data`` with a
tensor-parallel head over ``model``. Each model rank holds a slice of the
head's hidden features (``mesh.cnn_param_shardings``), computes
relu(x @ W1[:, cols] + b1[cols]) rounded to bf16 as ``CnnNet`` does, and
multiplies it by W2[cols, :]; one all-reduce over ``model`` sums the
partial outputs. Gradients of every parameter are summed over ``data``
(never over ``model``). The loss is the global batch's: its regression
term divides by the whole batch's ring weight, all-reduced over ``data``
before the division.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from ..models import cnn
from .mesh import cnn_param_shardings, local_shard, mesh_device, shard_frames


def _gather(mesh: DeviceMesh, dim: str, t: torch.Tensor,
            axis: int = 0) -> torch.Tensor:
    """All-gather `t` over mesh dimension `dim` in rank order and
    concatenate along `axis` (bool tensors travel as uint8)."""
    x = t.to(torch.uint8) if t.dtype == torch.bool else t
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(
        mesh.mesh_dim_names.index(dim)))]
    dist.all_gather(parts, x, group=mesh.get_group(dim))
    out = torch.cat(parts, dim=axis)
    return out.bool() if t.dtype == torch.bool else out


def _replicate(mesh: DeviceMesh, outputs):
    """Per-shard outputs (a tuple of [b, ...] tensors) → the whole
    batch's, on every process."""
    return tuple(_gather(mesh, "data", t) for t in outputs)


def _check_engine(engine, mesh: DeviceMesh) -> None:
    if engine.device != mesh_device(mesh):
        raise ValueError(f"engine on {engine.device}, this process's mesh "
                         f"device is {mesh_device(mesh)}")


def make_sharded_detect(engine, mesh: DeviceMesh):
    """The cascade engine's detection with the frame batch sharded on
    'data'. Returns fn(gray [B,H,W]) → (boxes, valid, overflow) of the
    whole batch on every process."""
    _check_engine(engine, mesh)

    def detect(gray):
        return _replicate(mesh, engine._detect_impl(shard_frames(mesh, gray)))

    return detect


def make_sharded_detect_grouped(engine, mesh: DeviceMesh,
                                min_neighbors: int = 3):
    """The FULL per-frame device program (cascade + on-device minNeighbors
    grouping) sharded over 'data'. Grouping is per-frame independent, so it
    runs shard-local; only the grouped [B,K] outputs are all-gathered.
    Returns fn(gray [B,H,W]) → (boxes, valid, weights, overflow)."""
    _check_engine(engine, mesh)

    def detect(gray):
        local = shard_frames(mesh, gray)
        return _replicate(mesh, engine._group_impl(
            *engine._detect_impl(local), min_neighbors=min_neighbors))

    return detect


def make_sharded_chain(face_engine, part_engines, mesh: DeviceMesh,
                       min_neighbors: int = 3):
    """The reference's default filter chain as one sharded device program:
    the face cascade (grouped on device) plus each part cascade at part
    resolution with candidates device-compacted (ONE face pass feeds all
    part detectors, kmseyedetect.cpp:680-724 chaining semantics).

    Both image batches are sharded on ``data``; only the grouped face boxes
    and the compacted part candidates are all-gathered. Returns
    fn(face_gray [B,fh,fw], part_gray [B,ph,pw]) →
    ((fboxes, fvalid, fweights, foverflow), {name: (pboxes, pvalid,
    poverflow)}).
    """
    for eng in (face_engine, *part_engines.values()):
        _check_engine(eng, mesh)
    names = list(part_engines)

    def chain(face_gray, part_gray):
        fg, pg = shard_frames(mesh, face_gray), shard_frames(mesh, part_gray)
        face = face_engine._group_impl(*face_engine._detect_impl(fg),
                                       min_neighbors=min_neighbors)
        parts = {n: part_engines[n]._compact_raw_impl(
            *part_engines[n]._detect_impl(pg)) for n in names}
        return (_replicate(mesh, face),
                {n: _replicate(mesh, parts[n]) for n in names})

    return chain


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over 'model' backward:
    the head's input feeds every model rank's slice of hidden features."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over 'model' forward (the sum of the slices' partial
    outputs), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallelCnnNet(cnn.CnnNet):
    """``CnnNet`` with its head split over the mesh's 'model' dimension:
    this process holds its slice of head1.w, head1.b and head2.w (and the
    replicated rest). Its forward equals ``CnnNet``'s up to the float32
    summation order of h @ W2."""

    def __init__(self, params: dict, mesh: DeviceMesh):
        placements = cnn_param_shardings(mesh, params)
        super().__init__({
            name: {leaf: local_shard(mesh, np.asarray(v),
                                     placements[name][leaf])
                   for leaf, v in layer.items()}
            for name, layer in params.items()})
        self.placements = placements
        self.mesh = mesh
        self.to(mesh_device(mesh))

    def forward(self, gray: torch.Tensor) -> torch.Tensor:
        group = self.mesh.get_group("model")
        x = (gray.to(torch.bfloat16) / 128.0 - 1.0)[:, None]   # NCHW
        for name, stride, dilation in self.layers:
            y = self._conv(x, name, stride, dilation)
            x = x + y if name == "ctx" else y
        x = _CopyToModel.apply(x.permute(0, 2, 3, 1).float(), group)
        h = torch.relu(x @ self._head_weight("head1") + self.head1["b"])
        part = h.to(torch.bfloat16).float() @ self._head_weight("head2")
        return _ReduceFromModel.apply(part, group) + self.head2["b"]

    def full_params(self) -> dict:
        """The whole parameters (sharded leaves all-gathered over 'model')
        as the JAX package's nested dict of float32 numpy arrays."""
        flat = {}
        for key, p in self.state_dict().items():
            name, leaf = key.split(".")
            pl = self.placements[name][leaf][1]
            if isinstance(pl, Shard):
                p = _gather(self.mesh, "model", p, axis=pl.dim)
            flat[key] = p
        return cnn.params_to_numpy(flat)


def sharded_loss(model: TensorParallelCnnNet, gray, obj_t, reg_t):
    """This data shard's share of ``cnn.loss_fn`` on the whole batch →
    (share, (obj share, reg share)); the shares sum over 'data' to the
    whole batch's loss, and so do their gradients. The objectness term is
    a mean over the whole batch's cells (shards are equal); the regression
    term divides this shard's weighted sum by the whole batch's ring
    weight, all-reduced over 'data' first, since the shards hold
    different numbers of positive and ring cells."""
    pred = model(gray)
    obj_logit = pred[..., 0]
    pos = (obj_t > 0).float()
    ign = (obj_t < 0).float()
    regw = (pos + (obj_t == -1).float())[..., None]
    bce = cnn.sigmoid_bce(obj_logit, pos)
    p = torch.sigmoid(obj_logit).detach()
    neg_w = (1.0 + cnn.NEG_FOCAL * p.square()) * (1.0 - ign)
    n_data = model.mesh.size(0)
    obj_loss = (bce * torch.where(pos > 0, cnn.POS_WEIGHT, neg_w)).sum() / (
        obj_logit.numel() * n_data)
    den = regw.sum()
    dist.all_reduce(den, group=model.mesh.get_group("data"))
    reg_loss = ((pred[..., 1:] - reg_t).abs() * regw).sum() / den.clamp(
        min=1.0)
    return obj_loss + reg_loss, (obj_loss, reg_loss)


def _param_placements(model: TensorParallelCnnNet) -> list:
    """The placements of ``model.parameters()``, in their order (the
    order of an optimizer's per-parameter state)."""
    return [model.placements[name][leaf] for name, leaf in (
        key.split(".") for key, _ in model.named_parameters())]


def shard_optimizer_state(model: TensorParallelCnnNet, state: dict) -> dict:
    """An optimizer ``state_dict()`` of the whole model (the unsharded
    ``CnnNet``'s, or ``full_optimizer_state``'s) → this process's: each
    parameter's tensors of its own shape (AdamW's moments) are split as
    that parameter is; step counts and the parameter groups stay whole."""
    placements = _param_placements(model)
    shards = {}
    for idx, per_param in state["state"].items():
        pl = placements[int(idx)]
        shards[idx] = {k: (local_shard(model.mesh, v, pl).contiguous()
                           if torch.is_tensor(v) and v.ndim else v)
                       for k, v in per_param.items()}
    return {"state": shards, "param_groups": state["param_groups"]}


def full_optimizer_state(model: TensorParallelCnnNet, optimizer) -> dict:
    """This process's optimizer ``state_dict()`` with each split tensor
    all-gathered over 'model': the whole model's state, equal on every
    process, which ``shard_optimizer_state`` splits again (and which an
    unsharded ``CnnNet``'s optimizer loads)."""
    placements = _param_placements(model)
    state = optimizer.state_dict()
    whole = {}
    for idx, per_param in state["state"].items():
        pl = placements[int(idx)][1]
        whole[idx] = {k: (_gather(model.mesh, "model", v, axis=pl.dim)
                          if isinstance(pl, Shard) and torch.is_tensor(v)
                          and v.ndim else v)
                      for k, v in per_param.items()}
    return {"state": whole, "param_groups": state["param_groups"]}


def make_sharded_train_step(mesh: DeviceMesh, params, lr: float = 3e-4,
                            steps: int | None = None, optimizer=None,
                            state: dict | None = None):
    """dp (batch over 'data') × tp (head features over 'model') training
    of the learned detector, the port of the JAX package's
    ``make_sharded_train_step(optimizer, mesh, params, opt_state)``.

    `params` is the nested parameter dict (the same on every process) or
    a ``TensorParallelCnnNet`` already built on `mesh`. `optimizer` is an
    (optimizer, scheduler) pair over that model's parameters, as
    ``cnn.make_optimizer(model.parameters(), lr, steps)`` returns it;
    without one the step builds ``cnn.make_optimizer`` at `lr`: constant,
    or on the warmup-cosine schedule over `steps`. `state` resumes a run:
    ``{"optimizer": ..., "scheduler": ...}``, the whole model's state
    dicts (an unsharded run's, as ``utils/checkpoint.save_train_state``
    writes them, or ``full_optimizer_state``'s); the AdamW moments are
    split as their parameters are, as the JAX package mirrors the
    parameter shardings leaf for leaf.

    Returns (step, model, (optimizer, scheduler)): step(gray [B,H,W],
    obj_t, reg_t) takes the whole batch (the same on every process),
    runs this process's shard of it on 'data', and returns the whole
    batch's (loss, (obj_loss, reg_loss)) on every process; it updates each
    process's shards and advances the schedule."""
    model = (params if isinstance(params, TensorParallelCnnNet)
             else TensorParallelCnnNet(params, mesh))
    if model.mesh is not mesh:
        raise ValueError("the model was built on another mesh")
    opt, sched = optimizer or cnn.make_optimizer(model.parameters(), lr,
                                                 steps)
    if state is not None:
        opt.load_state_dict(shard_optimizer_state(model, state["optimizer"]))
        sched.load_state_dict(state["scheduler"])
    data = mesh.get_group("data")

    def step(gray, obj_t, reg_t):
        opt.zero_grad(set_to_none=True)
        total, (obj_loss, reg_loss) = sharded_loss(
            model, shard_frames(mesh, gray), shard_frames(mesh, obj_t),
            shard_frames(mesh, reg_t))
        total.backward()
        grads = [p.grad for p in model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=data)         # one sum over 'data'
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
        opt.step()
        sched.step()
        losses = torch.stack([total, obj_loss, reg_loss]).detach()
        dist.all_reduce(losses, group=data)
        return losses[0], (losses[1], losses[2])

    return step, model, (opt, sched)
