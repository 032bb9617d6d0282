"""The process mesh of multi-GPU runs (counterpart of
``codenerf_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its chips with the axes
``(replica, data, model)`` and lets XLA place the collectives. The port
runs one process per card, started by ``torchrun``, and shapes the
processes as a ``torch.distributed`` ``DeviceMesh`` with the same axis
names and rules:

- ``data`` and, outermost, ``replica`` (JAX's multi-slice axis) are the
  batch axes. Training splits each step's ray batch over them and
  averages the gradients with one all-reduce a step
  (``training/train_step.py``); code fitting and eval split the object
  axis over them (``optimization/codes_opt.py``).
- ``model`` is tensor parallelism, which is not ported: a ``model`` axis
  above 1 raises (ROADMAP.md Queue 1, item 26). With ``model = 1`` every
  weight is replicated, so the batch axes span every process.

On the ``gloo`` backend the collectives here take CUDA tensors through
the host (two ranks sharing one card, a correctness run); on ``nccl``
they run on the card.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from codenerf_tpu_torch import resolve_device

ITEM_26 = ("tensor parallelism (a model axis > 1) is not ported "
           "(ROADMAP.md Queue 1, item 26)")


def mesh_shape(world: int, data: int = -1, model: int = 1,
               replica: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of JAX's ``make_mesh`` over ``world``
    processes: ``(data, model)``, or ``(replica, data, model)`` when
    ``replica > 1``; ``data=-1`` takes the remaining processes. Raises
    JAX's ``ValueError`` s (``mesh.py:29-52``). Needs no process group."""
    if data == -1:
        if world % (model * replica) != 0:
            raise ValueError(f"{world} devices not divisible by "
                             f"model*replica={model * replica}")
        data = world // (model * replica)
    if data * model * replica != world:
        raise ValueError(f"replica*data*model={replica * data * model} != "
                         f"device count {world}")
    if replica > 1:
        return (replica, data, model), ("replica", "data", "model")
    return (data, model), ("data", "model")


def check_model_axis(model: int) -> None:
    if model > 1:
        raise NotImplementedError(ITEM_26)


def make_mesh(data: int = -1, model: int = 1, replica: int = 1):
    """A ``DeviceMesh`` of :func:`mesh_shape`'s layout over the default
    process group, with JAX's axis names. A ``model`` axis above 1 raises
    ``NotImplementedError`` (item 26) once the shape has been checked."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_shape(dist.get_world_size(), data, model, replica)
    check_model_axis(model)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The batch axes in mesh order: ``('replica', 'data')`` on a 3-axis
    mesh, ``('data',)`` otherwise."""
    return tuple(a for a in ("replica", "data") if a in mesh.mesh_dim_names)


def n_batch_shards(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def batch_shard(mesh) -> Tuple[int, int]:
    """``(index, count)``: this process's place among the batch shards,
    replica-major then data, as JAX's ``P(("replica", "data"))`` orders
    them; the index is also its rank in :func:`batch_group`."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in batch_axes(mesh):
        index = index * mesh.size(mesh.mesh_dim_names.index(a)) + coord[a]
    return index, n_batch_shards(mesh)


def batch_group(mesh):
    """One process group over the batch axes (every process of its
    ``model`` coordinate)."""
    axes = batch_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def init_from_env(device="cuda", backend=None,
                  init_method: str = "env://") -> torch.device:
    """Join the default process group as ``torchrun`` describes it
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and return this process's
    device: ``cuda:LOCAL_RANK``, made current, with ``nccl``; the CPU with
    ``gloo``. ``backend`` overrides the choice (``gloo`` puts two ranks on
    one card). A failed initialisation raises; nothing falls back."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("RANK and WORLD_SIZE are not set: start the "
                           "processes with torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", rank))))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, rank=rank, world_size=world)
    return dev


def mesh_from_flags(device, data: int = -1, model: int = 1,
                    replica: int = 1):
    """``(mesh or None, device)`` for the CLIs' ``--data_axis``,
    ``--model_axis`` and ``--replica_axis``: a mesh when ``torchrun``
    started several processes or a flag is off its default, else none and
    ``device``. The flags are checked before any process group exists:
    ``--model_axis > 1`` raises item 26, a layout that does not match
    ``WORLD_SIZE`` :func:`mesh_shape`'s ``ValueError``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and (data, model, replica) == (-1, 1, 1):
        return None, resolve_device(device)
    check_model_axis(model)
    mesh_shape(world, data, model, replica)
    dev = init_from_env(device)
    return make_mesh(data, model, replica), dev


def is_writer() -> bool:
    """Global rank 0, or a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t``, or its host copy where ``group`` runs ``gloo`` and ``t`` is
    on the card."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Average ``tensors`` (f32) in place over ``group``: one buffer, one
    ``all_reduce`` (sum), divided by the group's size, copied back by one
    multi-tensor copy (a few launches in all, not one per tensor)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    buf = _staged(flat, group)
    dist.all_reduce(buf, group=group)
    if buf is not flat:
        flat.copy_(buf)
    flat /= dist.get_world_size(group)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors),
                         [p.view_as(t) for p, t in zip(parts, tensors)])


def broadcast_(tensors: Sequence[torch.Tensor], group) -> None:
    """Overwrite ``tensors`` in place with those of the group's rank 0."""
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        buf = _staged(t.to(torch.uint8) if t.dtype == torch.bool else t,
                      group)
        dist.broadcast(buf, src=src, group=group)
        if buf is not t:
            t.copy_(buf)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in
    the group's rank order, on ``x`` 's device."""
    buf = _staged(x.contiguous(), group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(x.device)
