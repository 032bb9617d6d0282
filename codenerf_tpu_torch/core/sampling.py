"""Depth sampling along rays (reference ``src/utils.py:21-32``) and the
hierarchical (importance) sampler.

Coarse z-values are the midpoints of a ``[near, far]`` linspace plus a
jitter of at most one half-cell. As in ``codenerf_tpu/core/sampling.py``
the per-ray jitter sits on a 1/256 lattice (one random byte per sample);
here the bytes come from a ``torch.Generator`` instead of a JAX key, so the
two packages draw different numbers from the same seed — tests hand both
the same jitter. ``near`` and ``far`` may be per-ray ``(R,)`` bounds (from
``ray_sphere_bounds`` or the occupancy grid).

:func:`sample_pdf` is the standard NeRF inverse-CDF sampler;
:func:`union_sorted_zvals` and :func:`merge_sorted_samples` put the coarse
and fine depths into one ascending order per ray, the latter carrying
per-sample payloads with exactly the permutation of the former.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def fixed_zvals(near: float, far: float, n_samples: int,
                device=None) -> torch.Tensor:
    """Deterministic linspace z-values (reference ``z_fixed=True``)."""
    return torch.linspace(near, far, n_samples, dtype=torch.float32,
                          device=device)


def f32_value(x: float) -> float:
    """``x`` rounded to float32, as a Python float: a scalar operand that
    enters a float32 op exactly, without a host-to-device copy (a tensor
    made from a Python number on the card synchronizes the stream)."""
    return float(np.float32(x))


def lerp_linspace(start: float, stop: float, n: int,
                  device=None) -> torch.Tensor:
    """``linspace`` as the JAX package computes it, bit for bit where the
    probes and the grid need it (``[0, 1]`` for any ``n``): steps
    ``iota · f32(1/(n-1))``, values ``start·(1 - s) + stop·s`` summed once,
    and ``stop`` itself last. ``torch.linspace`` rounds differently in the
    last bit. Built on the device from Python scalars."""
    f32 = torch.float32
    a, b = f32_value(start), f32_value(stop)
    if n == 1:
        return torch.full((1,), a, dtype=f32, device=device)
    s = torch.arange(n - 1, dtype=f32, device=device) * f32_value(
        1.0 / (n - 1))
    out = ((a * (1.0 - s)).double() + b * s.double()).float()
    return torch.cat([out, torch.full((1,), b, dtype=f32, device=device)])


def uniform01_u8(generator: torch.Generator, num_rays: int, n: int,
                 device=None) -> torch.Tensor:
    """U[0, 1) jitter on a 1/256 lattice, shape (num_rays, n)."""
    u8 = torch.randint(0, 256, (num_rays, n), generator=generator,
                       dtype=torch.int32, device=device)
    return u8.float() * (1.0 / 256.0)


def stratified_zvals(generator: Optional[torch.Generator], near, far,
                     n_samples: int, num_rays: Optional[int] = None,
                     shared: bool = False,
                     jitter: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
    """Jittered midpoints ``linspace(near + h, far - h, N) + U·h`` with
    ``h = (far - near) / (2N)``.

    Returns (num_rays, n_samples) for per-ray jitter or per-ray bounds
    (``near``/``far`` as (num_rays,) tensors), or (n_samples,) when
    ``shared`` (the reference's one-vector quirk) or ``num_rays`` is None.
    ``jitter`` (values in [0, 1), broadcastable to the result) replaces the
    generator's draw — the tests feed both packages the same numbers."""
    if torch.is_tensor(near) or torch.is_tensor(far):
        if num_rays is None or shared:
            raise ValueError("per-ray near/far requires num_rays and "
                             "per-ray jitter")
        near = torch.as_tensor(near, dtype=torch.float32,
                               device=device).expand(num_rays)
        far = torch.as_tensor(far, dtype=torch.float32,
                              device=device).expand(num_rays)
        half = ((far - near) / (2.0 * n_samples))[:, None]
        t = lerp_linspace(0.0, 1.0, n_samples, device=near.device)[None, :]
        base = near[:, None] + half + t * (far - near)[:, None] * (
            (n_samples - 1.0) / n_samples if n_samples > 1 else 0.0)
        if jitter is None:
            jitter = uniform01_u8(generator, num_rays, n_samples,
                                  near.device)
        return base + jitter.to(device=base.device,
                                dtype=torch.float32) * half
    half = (far - near) / (2.0 * n_samples)
    base = torch.linspace(near + half, far - half, n_samples,
                          dtype=torch.float32, device=device)
    if jitter is None:
        if shared or num_rays is None:
            jitter = torch.rand((n_samples,), generator=generator,
                                dtype=torch.float32, device=device)
        else:
            jitter = uniform01_u8(generator, num_rays, n_samples, device)
    return base + jitter.to(device=base.device, dtype=torch.float32) * half


def fine_uniforms(generator: Optional[torch.Generator], num_rays: int,
                  n_importance: int, device=None) -> torch.Tensor:
    """The probes of :func:`sample_pdf`'s random draw: U[0, 1 - 1e-6),
    (num_rays, n_importance) f32."""
    return torch.rand((num_rays, n_importance), generator=generator,
                      dtype=torch.float32, device=device) * (1.0 - 1e-6)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               n_importance: int, generator: Optional[torch.Generator] = None,
               deterministic: bool = False,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_importance`` depths per ray from the
    piecewise-constant pdf of ``weights`` (R, M) over the bin edges
    ``bins`` (R, M+1). Probes: ``linspace(0, 1 - 1e-5)`` when
    ``deterministic``, else ``u`` (R, n_importance) when given (the tests
    feed both packages the same draws), else uniforms in ``[0, 1 - 1e-6)``
    from ``generator``. Returns (R, n_importance), detached (importance
    samples are constants, as in standard NeRF)."""
    weights = weights.detach().float() + 1e-5   # no NaN cdf for empty rays
    bins = bins.detach().float()
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (R, M+1)
    R, M1 = cdf.shape
    if deterministic:
        u = lerp_linspace(0.0, 1.0 - 1e-5, n_importance,
                          device=cdf.device).expand(R, n_importance)
    elif u is None:
        u = fine_uniforms(generator, R, n_importance, cdf.device)
    u = u.to(device=cdf.device, dtype=torch.float32).contiguous()
    # side="right": the count of cdf entries <= u (JAX's compare-count)
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(idx - 1, 0, M1 - 2)
    above = torch.clamp(idx, 1, M1 - 1)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def union_sorted_zvals(z_coarse: torch.Tensor,
                       z_fine: torch.Tensor) -> torch.Tensor:
    """Coarse (R, Nc) or (Nc,) and fine (R, Nf) depths in one ascending
    order per ray, (R, Nc+Nf)."""
    z_coarse = z_coarse.expand(z_fine.shape[0], z_coarse.shape[-1])
    return torch.sort(torch.cat([z_coarse, z_fine], dim=-1), dim=-1).values


def merge_sorted_samples(z_coarse: torch.Tensor, z_fine: torch.Tensor,
                         coarse_payloads: Sequence[torch.Tensor],
                         fine_payloads: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Co-sort the union of coarse and fine samples with per-sample
    payloads (sigma and rgb planes, or the coarse mask and deltas).
    A stable sort of the concatenated ``[coarse, fine]`` z reproduces
    JAX's stable multi-operand ``lax.sort``: same permutation, ties
    coarse-first. Returns ``(z_all (R, Nc+Nf), merged payloads)``."""
    z_cat = torch.cat([z_coarse, z_fine], dim=-1)
    z_all, perm = torch.sort(z_cat, dim=-1, stable=True)
    merged = tuple(torch.gather(torch.cat([c, f], dim=-1), -1, perm)
                   for c, f in zip(coarse_payloads, fine_payloads))
    return z_all, merged
