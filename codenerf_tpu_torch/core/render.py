"""Volume rendering (reference ``src/utils.py:34-47``).

Counterpart of ``codenerf_tpu/core/render.py::composite``: deltas with a
1e10 terminal delta, ``alpha = 1 - exp(-sigma·delta)``, exclusive
transmittance with the 1e-10 floor, white-background completion
``rgb += 1 - acc``. Always float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class _CumprodPositive(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of a tensor with no zero
    entry (the transmittance factors ``1 - alpha + 1e-10``). The backward
    is PyTorch's own formula for that case, ``reversed_cumsum(out · g) /
    x``, without the test for zeros that PyTorch's backward reads back
    from the device: a stream synchronization in every backward of a
    composite."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


class RenderOutput(NamedTuple):
    rgb: torch.Tensor      # (R, 3) composited color
    depth: torch.Tensor    # (R,) expected termination depth
    acc: torch.Tensor      # (R,) accumulated opacity
    weights: torch.Tensor  # (R, S) compositing weights


def composite(sigmas: torch.Tensor, rgbs, z_vals: torch.Tensor,
              white_bg: bool = True) -> RenderOutput:
    """sigmas (R, S) or (R, S, 1); rgbs (R, S, 3) or a tuple of three
    (R, S) planes; z_vals (S,) shared or (R, S) per ray, ascending."""
    planes = isinstance(rgbs, (tuple, list))
    if not planes and sigmas.dim() == rgbs.dim():
        sigmas = sigmas[..., 0]
    sigmas = sigmas.float()
    rgbs = tuple(p.float() for p in rgbs) if planes else rgbs.float()
    z_vals = z_vals.float().expand(sigmas.shape)

    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], -1)
    alphas = 1.0 - torch.exp(-sigmas * deltas)
    trans = torch.cat([torch.ones_like(alphas[..., :1]),
                       1.0 - alphas + 1e-10], dim=-1)
    weights = alphas * _CumprodPositive.apply(trans)[..., :-1]

    if planes:
        rgb = torch.stack([torch.sum(weights * p, -1) for p in rgbs], -1)
    else:
        rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    acc = torch.sum(weights, dim=-1)
    if white_bg:
        rgb = rgb + (1.0 - acc)[..., None]
    return RenderOutput(rgb=rgb, depth=depth, acc=acc, weights=weights)


def composite_weights(sigmas: torch.Tensor,
                      z_vals: torch.Tensor) -> torch.Tensor:
    """The compositing weights alone, the math of :func:`composite`.
    The hierarchical coarse pass takes them from the sigma-only kernel's
    output to drive ``sample_pdf`` (``ops/fused_train.py``)."""
    sigmas = sigmas.float()
    z_vals = z_vals.float().expand(sigmas.shape)
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], -1)
    alphas = 1.0 - torch.exp(-sigmas * deltas)
    trans = torch.cat([torch.ones_like(alphas[..., :1]),
                       1.0 - alphas + 1e-10], dim=-1)
    return alphas * _CumprodPositive.apply(trans)[..., :-1]
