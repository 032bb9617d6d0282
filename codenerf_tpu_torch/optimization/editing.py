"""Shape/texture editing via latent-code interpolation (counterpart of
``codenerf_tpu/optimization/editing.py``).

CodeNeRF disentangles shape and texture codes, so edits are renders under
interpolated or swapped codes. Every image goes through the one eval
render path (``renderer.render_image``: on the card the forward kernels
where they take the render, else the plain module(s); deterministic
depths, no occupancy grid), one image per code pair from a
fixed camera; the JAX package maps a jitted renderer over the pairs, and
here a loop over them does the same work with nothing to compile.
"""

from __future__ import annotations

import torch

from codenerf_tpu_torch.config import Hparams, resolve_dtype
from codenerf_tpu_torch.core.sampling import lerp_linspace
from codenerf_tpu_torch.renderer import render_image


def interpolate_codes(code_a: torch.Tensor, code_b: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Linear interpolation grid between two codes: (n, D) with endpoints
    included (the JAX package's ``linspace``, bit for bit)."""
    t = lerp_linspace(0.0, 1.0, n, device=code_a.device)[:, None]
    return (1.0 - t) * code_a[None, :] + t * code_b[None, :]


@torch.no_grad()
def render_code_grid(model, hp: Hparams, shape_codes: torch.Tensor,
                     texture_codes: torch.Tensor, H: int, W: int, focal,
                     c2w, chunk: int = 4096,
                     fine_model=None) -> torch.Tensor:
    """Render one image per (shape, texture) code pair, ``shape_codes``
    and ``texture_codes`` (G, D), from a fixed camera. Returns (G, H, W,
    3) float32. Deterministic z-sampling (midpoints); ``fine_model`` the
    separate fine network, if the run has one."""
    cd = resolve_dtype(hp.compute_dtype)
    return torch.stack([
        render_image(model, hp.render, H, W, focal, c2w, s, t, None,
                     chunk=chunk, compute_dtype=cd, fine_model=fine_model)
        for s, t in zip(shape_codes, texture_codes)])


def render_shape_texture_matrix(model, hp: Hparams,
                                shape_codes: torch.Tensor,
                                texture_codes: torch.Tensor, H: int, W: int,
                                focal, c2w, chunk: int = 4096,
                                fine_model=None) -> torch.Tensor:
    """Full cross product: every shape code (Gs, D) rendered with every
    texture code (Gt, D) (the paper's disentanglement figure). Returns
    (Gs, Gt, H, W, 3)."""
    Gs, Gt = shape_codes.shape[0], texture_codes.shape[0]
    s_grid = torch.repeat_interleave(shape_codes, Gt, dim=0)
    t_grid = texture_codes.repeat(Gs, 1)
    imgs = render_code_grid(model, hp, s_grid, t_grid, H, W, focal, c2w,
                            chunk=chunk, fine_model=fine_model)
    return imgs.reshape(Gs, Gt, H, W, 3)
