"""Ray and image rendering through the plain ``CodeNeRF`` module — the
eval path (counterpart of ``codenerf_tpu/renderer.py``, coarse only).

The JAX package renders eval views through plain XLA (``apply_codenerf``
+ ``composite``), no Pallas kernel; here the same is plain PyTorch.
Hierarchical sampling, sphere bounds and occupancy grids are not ported
yet (ROADMAP.md) and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from codenerf_tpu_torch.config import RenderConfig
from codenerf_tpu_torch.core.rays import camera_rays
from codenerf_tpu_torch.core.render import RenderOutput, composite
from codenerf_tpu_torch.core.sampling import fixed_zvals, stratified_zvals


def chunk_plan(n_rays: int, target: int = 4096) -> tuple:
    """``(chunk, n_chunks, n_padded)``: an exact divisor of ``n_rays``
    >= target/2 when one exists, else a 128-multiple chunk with padding."""
    if n_rays <= target:
        return n_rays, 1, n_rays
    for c in range(target, target // 2 - 1, -1):
        if n_rays % c == 0:
            return c, n_rays // c, n_rays
    n_chunks = -(-n_rays // target)
    per_chunk = -(-n_rays // n_chunks)
    chunk = min(target, ((per_chunk + 127) // 128) * 128)
    n_chunks = -(-n_rays // chunk)
    return chunk, n_chunks, n_chunks * chunk


def pad_rays(x: torch.Tensor, n_padded: int) -> torch.Tensor:
    """Pad the leading axis to ``n_padded`` by repeating the last row."""
    n = x.shape[0]
    if n == n_padded:
        return x
    return torch.cat([x, x[-1:].expand(n_padded - n, *x.shape[1:])], dim=0)


def check_render_config(rcfg: RenderConfig) -> None:
    """Raise for the render options this slice does not port."""
    if rcfg.n_importance > 0:
        raise NotImplementedError(
            "N_importance > 0 (hierarchical sampling) is not ported yet "
            "(ROADMAP.md Queue 1, item 9)")
    if rcfg.bound_sphere_radius is not None:
        raise NotImplementedError(
            "bound_sphere_radius (sphere-bounded sampling) is not ported yet "
            "(ROADMAP.md Queue 1, item 8)")


def coarse_zvals(rcfg: RenderConfig, ray_o: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Coarse depth samples (R, n_samples) over the global [near, far]
    slab: linspace when ``generator`` is None (deterministic), else
    stratified with per-ray (or the reference's shared) jitter."""
    check_render_config(rcfg)
    R, dev = ray_o.shape[0], ray_o.device
    if generator is None:
        z = fixed_zvals(rcfg.near, rcfg.far, rcfg.n_samples, device=dev)
    else:
        z = stratified_zvals(generator, rcfg.near, rcfg.far, rcfg.n_samples,
                             num_rays=R, shared=rcfg.shared_jitter,
                             device=dev)
    return z.expand(R, rcfg.n_samples)


def render_rays(model, rcfg: RenderConfig, ray_o: torch.Tensor,
                viewdir: torch.Tensor, shape_code: torch.Tensor,
                texture_code: torch.Tensor,
                generator: Optional[torch.Generator],
                compute_dtype: torch.dtype = torch.bfloat16) -> RenderOutput:
    """Render a batch of rays (coarse pass): plain ``CodeNeRF`` forward and
    ``composite``."""
    z = coarse_zvals(rcfg, ray_o, generator)
    xyz = ray_o[:, None, :] + viewdir[:, None, :] * z[..., None]
    sigmas, rgbs = model(xyz, viewdir, shape_code, texture_code,
                         compute_dtype=compute_dtype)
    return composite(sigmas, rgbs, z, white_bg=rcfg.white_bg)


@torch.no_grad()
def render_image(model, rcfg: RenderConfig, H: int, W: int, focal, c2w,
                 shape_code: torch.Tensor,
                 texture_code: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 chunk: int = 4096,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Render a full H×W image in fixed-size ray chunks; (H, W, 3) f32."""
    dev = shape_code.device
    n_rays = H * W
    chunk, n_chunks, n_padded = chunk_plan(n_rays, chunk)
    ray_o, viewdir = camera_rays(H, W, focal, c2w, device=dev)
    ro = pad_rays(ray_o, n_padded)
    vd = pad_rays(viewdir, n_padded)
    rgb = torch.cat([
        render_rays(model, rcfg, ro[i * chunk:(i + 1) * chunk],
                    vd[i * chunk:(i + 1) * chunk], shape_code, texture_code,
                    generator, compute_dtype=compute_dtype).rgb
        for i in range(n_chunks)])
    return rgb[:n_rays].reshape(H, W, 3)
