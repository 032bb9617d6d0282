"""The code tables' gather and its gradient, summed in a fixed order.

The training step gathers each ray's shape and texture codes from the
per-object tables (JAX ``codenerf_tpu/training/train_step.py:255-256``
and ``:329-330``, ``tr["shape_codes"][batch["obj"]]``); the gradient of
that gather sums the rays' cotangents into their objects' rows — XLA's
scatter-add, the gather's transpose. PyTorch's backward of
``index_select`` is ``index_add_``, which adds with f32 atomics on the
card in whatever order the rays arrive, so two trainings from one seed
part in the last bits and then everywhere; the deterministic library
route (``index_put_(accumulate=True)``, which
``torch.use_deterministic_algorithms`` picks) sorts and serialises over
the repeated rows (~5 ms a 16,384-ray step). Here:

- :class:`RowOrder`: the stable argsort of the rays' objects (an
  object's rays keep their ray order) and each object's segment of it,
  built on the device from ``obj`` with no host sync, once a
  (micro)batch and shared by both tables;
- :func:`code_row_sums`: the (R, D) f32 cotangents to the (n_rows, D)
  table gradient in one fixed order — tiles of :data:`TILE` consecutive
  rays in object order, each object's running sum within a tile, then
  each object's row: its first tile's partial, plus the partial of every
  later tile its segment reaches, in tile order; 0 for an object with no
  rays. On CUDA tensors it launches ``code_row_tiles_kernel`` and
  ``code_row_fold_kernel`` of ``csrc/code_rows.cu`` (one call, counted
  in ``launches["code_rows"]``, its R·D in ``points``); on CPU tensors
  it runs :func:`code_row_sums_plain`, the same additions in the same
  order, so the card check demands the same bits;
- :func:`gather_code_rows`: the gather as an ``autograd.Function``:
  forward ``index_select``, backward :func:`code_row_sums`
  (``gather_code_rows.calls`` counts its forwards on any device).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

TILE = 64   # rays a tile (kTile in csrc/code_rows.cu)

launches = {"code_rows": 0}
# The elements (R * D) of those launches' cotangents.
points = {"code_rows": 0}

_KERNEL = "code_rows"


@dataclasses.dataclass(frozen=True)
class RowOrder:
    """The rays in object order: ``perm`` (R,) the stable argsort of
    ``obj``, ``sorted_obj`` (R,) ``obj[perm]`` and ``offsets``
    (n_rows + 1,) where each object's segment of it starts (an object
    with no rays has an empty one); all int32 on ``obj`` 's device (a
    32-bit sort takes half the radix passes of a 64-bit one)."""
    perm: torch.Tensor
    sorted_obj: torch.Tensor
    offsets: torch.Tensor

    @classmethod
    def of(cls, obj: torch.Tensor, n_rows: int) -> "RowOrder":
        sorted_obj, perm = torch.sort(obj.int(), stable=True)
        rows = torch.arange(n_rows + 1, dtype=torch.int32, device=obj.device)
        return cls(perm.int(), sorted_obj,
                   torch.searchsorted(sorted_obj, rows, out_int32=True))


def code_row_sums_plain(g: torch.Tensor, order: RowOrder,
                        n_rows: int) -> torch.Tensor:
    """:func:`code_row_sums` in plain PyTorch, in the kernel's order: the
    running sum of each tile's segments (every segment starts from 0.0),
    each segment's sum where it ends in the tile — in ``head[obj]`` if it
    started in the tile, else in ``tail[tile]`` — then ``head[obj]`` plus
    the ``tail`` of each later tile of its segment, left to right."""
    R, D = g.shape
    dev = g.device
    out = torch.zeros(n_rows, D, dtype=g.dtype, device=dev)
    if R == 0:
        return out
    n_tiles = -(-R // TILE)
    pad = n_tiles * TILE - R
    gs = F.pad(g.index_select(0, order.perm), (0, 0, 0, pad)).view(
        n_tiles, TILE, D)
    so = order.sorted_obj
    sop = F.pad(so, (0, pad), value=-1).view(n_tiles, TILE)
    new = torch.ones_like(sop, dtype=torch.bool)
    new[:, 1:] = sop[:, 1:] != sop[:, :-1]
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    acc = torch.zeros(n_tiles, D, dtype=g.dtype, device=dev)
    running = []
    for k in range(TILE):
        acc = torch.where(new[:, k, None], zero, acc) + gs[:, k]
        running.append(acc)
    run = torch.stack(running, 1).view(-1, D)[:R]
    p = torch.arange(R, device=dev)
    tile = p // TILE
    end = (p + 1) % TILE == 0
    end[:-1] |= so[1:] != so[:-1]
    end[-1] = True
    here = order.offsets[so] >= tile * TILE
    head = torch.zeros(n_rows, D, dtype=g.dtype, device=dev)
    tail = torch.zeros(n_tiles, D, dtype=g.dtype, device=dev)
    head[so[end & here].long()] = run[end & here]
    tail[tile[end & ~here]] = run[end & ~here]
    b, e = order.offsets[:-1], order.offsets[1:]
    full = e > b
    first, last = (b // TILE).long(), ((e - 1).clamp_min(0) // TILE).long()
    out = torch.where(full[:, None], head, out)
    for j in range(1, int((last - first).max()) + 1 if n_rows else 1):
        t = first + j
        on = (full & (t <= last))[:, None]
        out = torch.where(on, out + tail[t.clamp(max=n_tiles - 1)], out)
    return out


def code_row_sums(g: torch.Tensor, order: RowOrder,
                  n_rows: int) -> torch.Tensor:
    """The (n_rows, D) f32 gradient of a table whose rows the R rays
    gathered, from their (R, D) f32 cotangents ``g``, in
    :class:`RowOrder` 's fixed order. CUDA tensors launch the kernel (g
    contiguous; the order on g's device) or raise; CPU tensors take
    :func:`code_row_sums_plain`."""
    R, D = g.shape
    if order.perm.shape != (R,) or order.offsets.shape != (n_rows + 1,):
        raise ValueError(f"code_row_sums: an order of {order.perm.shape[0]} "
                         f"rays and {order.offsets.shape[0] - 1} rows for g "
                         f"of {R} rays and {n_rows} rows")
    dev = g.device
    if dev.type == "cpu":
        return code_row_sums_plain(g, order, n_rows)
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"code_row_sums: g must be contiguous f32, got "
                         f"{g.dtype}")
    idx = (order.perm, order.sorted_obj, order.offsets)
    if dev.type != "cuda" or any(
            x.device != dev or x.dtype != torch.int32 or not x.is_contiguous()
            for x in idx):
        raise ValueError("code_row_sums launches the CUDA kernel on CUDA "
                         "tensors of one device (int32 order); its plain "
                         "version is code_row_sums_plain")
    head = torch.empty(n_rows, D, dtype=torch.float32, device=dev)
    tail = torch.empty(max(1, -(-R // TILE)), D, dtype=torch.float32,
                       device=dev)
    out = torch.empty(n_rows, D, dtype=torch.float32, device=dev)
    ptr = [ctypes.c_void_p(x.data_ptr()) for x in (g, *idx, head, tail, out)]
    rc = library().code_row_sums_step(
        *ptr, R, D, n_rows,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"code_row_sums CUDA kernel failed: cudaError {rc}")
    launches["code_rows"] += 1
    points["code_rows"] += R * D
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, obj, order):
        ctx.order, ctx.n_rows = order, table.shape[0]
        return table.index_select(0, obj)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return (code_row_sums(g.contiguous(), ctx.order, ctx.n_rows), None,
                None)


def gather_code_rows(table: torch.Tensor, obj: torch.Tensor,
                     order: RowOrder) -> torch.Tensor:
    """``table.index_select(0, obj)`` whose gradient is
    :func:`code_row_sums` in ``order`` (:meth:`RowOrder.of` of ``obj``
    and the table's rows)."""
    gather_code_rows.calls += 1
    return _GatherRows.apply(table, obj, order)


gather_code_rows.calls = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.code_row_sums_step.argtypes = [vp] * 7 + [ci] * 3 + [vp]
    lib.code_row_sums_step.restype = ci


def library() -> ctypes.CDLL:
    """``csrc/code_rows.cu`` built (at first use), loaded and bound."""
    from codenerf_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    if not getattr(lib, "_bound", False):
        _bind(lib)
        lib._bound = True
    return lib
