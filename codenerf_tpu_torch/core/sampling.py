"""Depth sampling along rays (reference ``src/utils.py:21-32``).

Coarse z-values are the midpoints of a ``[near, far]`` linspace plus a
jitter of at most one half-cell. As in ``codenerf_tpu/core/sampling.py``
the per-ray jitter sits on a 1/256 lattice (one random byte per sample);
here the bytes come from a ``torch.Generator`` instead of a JAX key, so the
two packages draw different numbers from the same seed — tests hand both
the same jitter.
"""

from __future__ import annotations

from typing import Optional

import torch


def fixed_zvals(near: float, far: float, n_samples: int,
                device=None) -> torch.Tensor:
    """Deterministic linspace z-values (reference ``z_fixed=True``)."""
    return torch.linspace(near, far, n_samples, dtype=torch.float32,
                          device=device)


def uniform01_u8(generator: torch.Generator, num_rays: int, n: int,
                 device=None) -> torch.Tensor:
    """U[0, 1) jitter on a 1/256 lattice, shape (num_rays, n)."""
    u8 = torch.randint(0, 256, (num_rays, n), generator=generator,
                       dtype=torch.int32, device=device)
    return u8.float() * (1.0 / 256.0)


def stratified_zvals(generator: Optional[torch.Generator], near: float,
                     far: float, n_samples: int,
                     num_rays: Optional[int] = None, shared: bool = False,
                     jitter: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
    """Jittered midpoints ``linspace(near + h, far - h, N) + U·h`` with
    ``h = (far - near) / (2N)``.

    Returns (num_rays, n_samples) for per-ray jitter, or (n_samples,) when
    ``shared`` (the reference's one-vector quirk) or ``num_rays`` is None.
    ``jitter`` (values in [0, 1), broadcastable to the result) replaces the
    generator's draw — the tests feed both packages the same numbers."""
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
