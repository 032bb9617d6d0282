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
  axis over them (``optimization/codes_opt.py``), and the ranks of one
  ``model`` group fit the same objects.
- ``model`` splits the training state (tensor parallelism, the autodiff
  route only, as in JAX). JAX's rule looks only at shapes
  (:func:`shard_dim`): a leaf whose last axis is a multiple of
  128·|model| is sharded on it — an ``nn.Linear`` 's weight (out, in)
  and bias on dimension 0, a code table (n, D) on dimension 1 — and its
  AdamW moments follow it; the rest is replicated. At W = 256 and
  ``model = 2`` that is every layer of output width 256 and, at latent
  256, both code tables; at ``model = 4`` nothing.

How the port runs a ``model`` axis: each rank keeps only its slices of
the sharded leaves (weights, moments, code-table columns), and each
forward all-gathers the whole f32 weights and tables over ``model``
(:class:`ModelShards`, one collective). The gather's backward is the
slice, not a reduce-scatter: the batch is replicated over ``model``
(JAX's batch sharding is ``P("data")``), so every rank of a ``model``
group computes the same whole gradient and keeps its own columns — a
reduce-scatter would multiply it by |model|. The replicated leaves'
gradients (and the step's metrics) are then taken from the group's first
rank, one broadcast, so that a kernel that does not repeat its bits —
multithreaded CPU kernels, atomics on the card — cannot set the ranks'
copies apart. The batch axes then average each rank's slices as without
the axis, and each rank's AdamW updates its own slices. At ``(data=1,
model=2)`` every rank runs one process's arithmetic, bit for bit.

Of the two layouts this one moves the fewest bytes for this MLP: at the
flagship widths and ``model = 2`` a rank receives about 1.4 MB a network
a gather, plus the tables' 2.5 MB at 2,458 objects (latent 256), where
column-parallel products with gathered activations would move about
0.7 GB of forward gathers and 1.2 GB of backward all-reduces a step at
4,096 × 96 points. So the batch axes split the work and ``model`` splits
the state; a ~715K-parameter MLP needs no tensor parallelism for its
memory (the JAX docstring says as much) — the axis is there for wide-W
variants and for layout parity.

On the ``gloo`` backend the collectives here take CUDA tensors through
the host (two ranks sharing one card, a correctness run); on ``nccl``
they run on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from codenerf_tpu_torch import resolve_device

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


def make_mesh(data: int = -1, model: int = 1, replica: int = 1,
              timeout: Optional[datetime.timedelta] = None):
    """A ``DeviceMesh`` of :func:`mesh_shape`'s layout over the default
    process group, with JAX's axis names. ``timeout`` bounds every
    collective on it — the default group, each axis's group and the
    batch axes' (:func:`batch_group`) — so that a rank waiting on a dead
    peer raises and reaches the trainer's crash-safe save instead of
    waiting forever (on ``nccl`` a timed-out collective raises only with
    ``TORCH_NCCL_BLOCKING_WAIT=1``; otherwise NCCL's watchdog ends the
    process)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_shape(dist.get_world_size(), data, model, replica)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=names)
    if timeout is not None:
        groups = [dist.group.WORLD, batch_group(mesh)] + [
            mesh.get_group(n) for n in names]
        for g in groups:
            dist.distributed_c10d._set_pg_timeout(timeout, g)
    return mesh


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


def model_size(mesh) -> int:
    """|model|: 1 without a mesh."""
    return 1 if mesh is None else mesh.size(
        mesh.mesh_dim_names.index("model"))


def model_group(mesh):
    """The process group over the ``model`` axis (every process of its
    batch coordinates)."""
    return mesh.get_group("model")


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
    ``device``. The flags are checked before any process group exists: a
    layout that does not match ``WORLD_SIZE`` raises :func:`mesh_shape`'s
    ``ValueError``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and (data, model, replica) == (-1, 1, 1):
        return None, resolve_device(device)
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


# ------------------------------------------------------------ the model axis
def shard_dim(name: str, shape, model: int) -> Optional[int]:
    """JAX's ``_leaf_spec`` (``codenerf_tpu/parallel/mesh.py``) in torch
    layout: the dimension of a leaf that holds JAX's last axis — 0 for an
    ``nn.Linear`` 's ``.weight`` (out, in; JAX stores (in, out)) and
    ``.bias``, the last otherwise (the code tables, (n, D) in both) —
    when its size is a multiple of ``128 * model``; else None
    (replicated). Depends only on the name and the shape."""
    if model <= 1 or len(shape) == 0:
        return None
    d = 0 if name.endswith((".weight", ".bias")) else len(shape) - 1
    return d if shape[d] % (128 * model) == 0 else None


@dataclasses.dataclass
class ModelShards:
    """A state's split over the ``model`` axis: ``dims`` maps each
    trainable's name to its sharded dimension (:func:`shard_dim` on the
    whole shape) or None; this rank holds block ``rank`` of ``size`` on
    that dimension."""
    group: Any
    size: int
    rank: int
    dims: Dict[str, Optional[int]]

    @classmethod
    def of(cls, mesh, shapes: Dict[str, Sequence[int]]) -> "ModelShards":
        """The split of leaves of the whole ``shapes`` over ``mesh`` 's
        ``model`` axis."""
        size = model_size(mesh)
        group = model_group(mesh)
        return cls(group, size, dist.get_rank(group),
                   {n: shard_dim(n, s, size) for n, s in shapes.items()})

    def slice(self, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's block of the whole ``x`` on ``dim`` (``x`` itself
        when None), in storage of its own."""
        if dim is None:
            return x
        k = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * k, k).clone(
            memory_format=torch.contiguous_format)

    def gather(self, shards: Sequence[torch.Tensor],
               dims: Sequence[int]) -> List[torch.Tensor]:
        """The whole tensors of ``shards`` (each rank's block on its dim),
        from one all-gather over the group; differentiable: the backward
        of each is its slice of the whole gradient (the module
        docstring)."""
        return list(_GatherShards.apply(self, tuple(dims), *shards))

    def whole(self, named: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """``named`` (name -> this rank's leaf) with every sharded leaf
        gathered whole (:meth:`gather`), the replicated ones as they
        are."""
        names = [n for n in named if self.dims.get(n) is not None]
        out = dict(named)
        out.update(zip(names, self.gather([named[n] for n in names],
                                          [self.dims[n] for n in names])))
        return out


    def share_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` in place with the group's rank 0's: one
        broadcast of one buffer."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        broadcast_([flat], self.group)
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(list(tensors),
                             [p.view_as(t) for p, t in zip(parts, tensors)])


def _gather_whole(shards: Sequence[torch.Tensor], dims: Sequence[int],
                  group) -> List[torch.Tensor]:
    """One all-gather of every rank's ``shards`` (flattened into one
    buffer), each reassembled whole along its dim in rank order."""
    m = dist.get_world_size(group)
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    parts = all_gather_cat(flat, group).view(m, -1)
    out, at = [], 0
    for s, d in zip(shards, dims):
        block = parts[:, at:at + s.numel()].reshape(m, *s.shape)
        shape = list(s.shape)
        shape[d] *= m
        out.append(block.movedim(0, d).reshape(shape))
        at += s.numel()
    return out


class _GatherShards(torch.autograd.Function):
    """:meth:`ModelShards.gather`: forward the all-gather, backward this
    rank's slice of each whole gradient."""

    @staticmethod
    def forward(ctx, shards: ModelShards, dims, *xs):
        ctx.shards, ctx.dims = shards, dims
        return tuple(_gather_whole(xs, dims, shards.group))

    @staticmethod
    def backward(ctx, *grads):
        sh = ctx.shards
        return (None, None) + tuple(
            None if g is None else sh.slice(g, d)
            for g, d in zip(grads, ctx.dims))
