"""Device mesh + sharding layer (SURVEY.md §2.5) over ``torch.distributed``
— the port of ``nubomedia_vca_tpu/parallel/mesh.py``.

The reference has no distributed backend (one GStreamer thread per filter;
scale-out was one-pipeline-per-stream across Kurento instances). Here those
concurrency dimensions map onto one process per device (SPMD):

  * one-filter-per-stream        → batch/data parallelism over a ``data``
    mesh dimension: frame batches from many streams sharded across devices
  * per-frame cascade stages     → stay on one device (the kernels)
  * window-grid parallelism      → ``model`` dimension for the learned
    detector's tensor-parallel head
  * cross-shard result gather    → collectives (all_gather / all_reduce)

Every process holds the whole (replicated) input and takes its own shard
of it (``shard_frames``); outputs are gathered so that every process holds
them whole, as the JAX package's ``out_shardings=replicated`` does. The
process group is NCCL for CUDA devices, one process per card, and gloo for
the CPU; nothing falls back from one to the other. Ranks are laid out
data-major, rank = data·n_model + model, the JAX mesh's device order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..cascade.engine import _resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(coordinator: str | None = None, num_processes=None,
                     process_id=None, device_type: str = "cuda") -> None:
    """Join the process group (no-op when `coordinator` is None). The
    coordinator is an ``init_method`` URL (``tcp://host:port`` or
    ``file:///path``; a bare ``host:port`` means tcp). The backend follows
    the device: NCCL for ``cuda``, with this process on card
    ``process_id`` modulo the host's card count, gloo for ``cpu``."""
    if coordinator is None:
        return
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: one of "
                         f"{sorted(BACKENDS)}")
    if device_type == "cuda":
        _resolve_device("cuda")          # raises without a card
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(BACKENDS[device_type], init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """('data', 'model') mesh over every process of the group. Defaults
    to all of them on 'data'."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the "
                         f"{world} processes of the group")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device in the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def frame_sharding(mesh: DeviceMesh) -> tuple:
    """Frame batches sharded over streams/batch on the data dimension."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())


def cnn_param_shardings(mesh: DeviceMesh, params: dict) -> dict:
    """Data-parallel backbone (replicated) + tensor-parallel head: head1.w
    is split over its output features, head1.b with it, head2.w over its
    input features, all on 'model' — the classic pair that needs exactly
    one all-reduce. `params` is the nested parameter dict; the result has
    its structure, each leaf the placements over ('data', 'model')."""
    split = {("head1", "w"): 1, ("head1", "b"): 0, ("head2", "w"): 0}
    return {name: {leaf: ((Replicate(), Shard(split[name, leaf]))
                          if (name, leaf) in split else replicated(mesh))
                   for leaf in layer}
            for name, layer in params.items()}


def local_shard(mesh: DeviceMesh, value, placements: tuple):
    """This process's part of a whole array or tensor under `placements`
    (a ``Shard(d)`` on a mesh dimension takes this process's equal slice of
    axis d; sizes must divide)."""
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(mdim)
            if value.shape[p.dim] % n:
                raise ValueError(
                    f"axis {p.dim} of size {value.shape[p.dim]} does not "
                    f"split over {n} on '{mesh.mesh_dim_names[mdim]}'")
            k = value.shape[p.dim] // n
            i = mesh.get_local_rank(mdim)
            index = [slice(None)] * value.ndim
            index[p.dim] = slice(i * k, (i + 1) * k)
            value = value[tuple(index)]
    return value


def shard_frames(mesh: DeviceMesh, frames) -> torch.Tensor:
    """This process's shard (on 'data') of a whole frame batch, numpy or
    tensor, as a contiguous tensor on its device. The batch must split
    evenly over 'data'."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    return local_shard(mesh, frames, frame_sharding(mesh)).to(
        mesh_device(mesh)).contiguous()
