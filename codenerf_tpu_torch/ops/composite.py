"""The standalone volume-rendering composite and its backward.

Replaces ``codenerf_tpu/ops/pallas_composite.py::_call`` (bodies
``_fwd_kernel`` and ``_bwd_kernel``, built by ``make_composite_op``): the
composite of ``core/render.py`` (reference ``src/utils.py:34-47``) on
five (R, S) f32 planes — densities with softplus applied, the raw r, g,
b, the depths — to one per-ray ``(R, 8)`` f32 row ``[r | g | b | depth |
acc | 0 0 0]``, and a backward that recomputes the forward and returns the
five plane cotangents, the depths' included (the plane op's route on
padded code-optimization chunks, ``ops/fused_train._with_composite``).

On CUDA tensors :func:`composite_fwd` and :func:`composite_bwd` launch
``composite_fwd`` / ``composite_bwd`` of ``csrc/train_fused.cu``: eight
rays a block, one warp per ray, the single-pass kernel's
``composite_pass`` (an exclusive product scan for the transmittance, a
reverse scan for the backward's suffix sums) on the ray's planes in
registers — each lane loads its own consecutive samples, 16 bytes at a
time where the shape allows, and the backward writes its cotangents from
there; white or black background. The TPU spelled the transmittance as a log-space triangular
(S, S) matmul over fat ray tiles for its matrix unit; the warp scan is
the natural spelling here. What bounds them on an H100: the bytes —
forward 5·R·S·4 in and 32·R out, backward 5·R·S·4 + 32·R in and 5·R·S·4
out (7.9 MB and 15.8 MB at 4096 × 96: ~2.4 µs and ~4.7 µs at 3.35
TB/s); their arithmetic is a few dozen f32 operations per sample.
:func:`composite_fwd_plain` and :func:`composite_bwd_plain` are their
plain versions (``fused_mlp.composite_fwd_in_kernel`` /
``composite_bwd_in_kernel``); ``launches["composite"]`` and
``launches["composite_bwd"]`` count the launches (``points`` their
R·S). :func:`composite_op`
is the differentiable op (``make_composite_op``'s custom VJP).
"""

from __future__ import annotations

import ctypes

import torch

from codenerf_tpu_torch.ops import fused_mlp

launches = {"composite": 0, "composite_bwd": 0}
# The points (R * S) of those launches, per mode.
points = {"composite": 0, "composite_bwd": 0}


def _check(planes, R: int, S: int, what: str):
    for x in planes:
        if x.shape != (R, S):
            raise ValueError(f"{what}: a plane has shape {tuple(x.shape)}, "
                             f"expected {(R, S)}")
    dev = planes[-1].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def composite_fwd(sig, c0, c1, c2, z, white_bg: bool) -> torch.Tensor:
    """``(R, 8)`` f32 ``[r g b depth acc 0 0 0]`` of the planes (R, S)."""
    R, S = z.shape
    dev = _check((sig, c0, c1, c2, z), R, S, "composite_fwd")
    if dev.type == "cpu":
        return composite_fwd_plain(sig, c0, c1, c2, z, white_bg)
    ins = _cuda_planes((sig, c0, c1, c2, z), dev)
    out8 = torch.empty(R, 8, dtype=torch.float32, device=dev)
    _run("composite_fwd", *ins, out8, R=R, S=S, white_bg=white_bg, dev=dev)
    launches["composite"] += 1
    points["composite"] += R * S
    return out8


def composite_fwd_plain(sig, c0, c1, c2, z, white_bg: bool) -> torch.Tensor:
    """:func:`composite_fwd` in plain PyTorch."""
    return fused_mlp.composite_fwd_in_kernel(
        *(x.float() for x in (sig, c0, c1, c2, z)), white_bg)[0]


def composite_bwd(sig, c0, c1, c2, z, g8, white_bg: bool):
    """``(gsig, gc0, gc1, gc2, dz)``, (R, S) f32: the cotangents of the
    five planes for the per-ray cotangent ``g8`` (R, 8) — its r, g, b,
    depth and acc lanes."""
    R, S = z.shape
    dev = _check((sig, c0, c1, c2, z), R, S, "composite_bwd")
    if tuple(g8.shape) != (R, 8):
        raise ValueError(f"composite_bwd: g8 is {tuple(g8.shape)}, expected "
                         f"{(R, 8)}")
    if dev.type == "cpu":
        return composite_bwd_plain(sig, c0, c1, c2, z, g8, white_bg)
    ins = _cuda_planes((sig, c0, c1, c2, z, g8), dev)
    outs = [torch.empty(R, S, dtype=torch.float32, device=dev)
            for _ in range(5)]
    _run("composite_bwd", *ins, *outs, R=R, S=S, white_bg=white_bg, dev=dev)
    launches["composite_bwd"] += 1
    points["composite_bwd"] += R * S
    return tuple(outs)


def composite_bwd_plain(sig, c0, c1, c2, z, g8, white_bg: bool):
    """:func:`composite_bwd` in plain PyTorch."""
    planes = [x.float() for x in (sig, c0, c1, c2, z)]
    _, aux = fused_mlp.composite_fwd_in_kernel(*planes, white_bg)
    return fused_mlp.composite_bwd_in_kernel(*planes, g8.float(), aux,
                                             white_bg)


def _cuda_planes(xs, dev):
    from codenerf_tpu_torch.ops.fused_train import _aligned

    out = [_aligned(x, torch.float32) for x in xs]
    for x in out:
        if x.device != dev:
            raise ValueError(f"composite: an input lies on {x.device}, "
                             f"expected {dev}")
    return out


def _run(fn: str, *tensors, R: int, S: int, white_bg: bool, dev):
    from codenerf_tpu_torch.ops.fused_train import _MAX_SAMPLES, library

    if S > _MAX_SAMPLES:
        raise ValueError(f"composite: the CUDA kernel takes S <= "
                         f"{_MAX_SAMPLES}; got S={S}")
    rc = getattr(library(), fn)(
        *[ctypes.c_void_p(x.data_ptr()) for x in tensors], R, S,
        int(bool(white_bg)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{fn} CUDA kernel failed: cudaError {rc}")


class CompositeOp(torch.autograd.Function):
    """``apply(white_bg, sig, c0, c1, c2, z) -> (R, 8)``: the forward
    keeps its five planes, the backward recomputes the composite
    (:func:`composite_bwd`)."""

    @staticmethod
    def forward(ctx, white_bg, sig, c0, c1, c2, z):
        ctx.white_bg = white_bg
        ctx.save_for_backward(sig, c0, c1, c2, z)
        return composite_fwd(sig, c0, c1, c2, z, white_bg)

    @staticmethod
    def backward(ctx, g8):
        return (None,) + tuple(composite_bwd(*ctx.saved_tensors, g8,
                                             ctx.white_bg))


def composite_op(sig, c0, c1, c2, z, white_bg: bool = True) -> torch.Tensor:
    """The differentiable standalone composite (the op that
    ``make_composite_op`` builds in the JAX package)."""
    return CompositeOp.apply(white_bg, sig, c0, c1, c2, z)
