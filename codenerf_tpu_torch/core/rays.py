"""Pinhole camera rays (reference ``src/utils.py:10-19``).

Camera-frame direction of pixel (u, v) is ``[(u - W/2)/f, -(v - H/2)/f,
-1]``, rotated into the world by ``c2w[:3, :3]``; origins are the camera
center. Counterpart of ``codenerf_tpu/core/rays.py::camera_rays`` (whole
images, for eval) and ``pixel_rays`` (batches of pixels, for training).
"""

from __future__ import annotations

from typing import Tuple

import torch


def camera_rays(H: int, W: int, focal, c2w, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All H·W rays of pose ``c2w`` (4×4 or 3×4), row-major pixel order.
    Returns (origins (H·W, 3), unit viewdirs (H·W, 3)) float32."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    dev = c2w.device
    focal = torch.as_tensor(focal, dtype=torch.float32, device=dev)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(u - W * 0.5) / focal, -(v - H * 0.5) / focal,
                        -torch.ones_like(u)], dim=-1)          # (H, W, 3)
    rays_d = dirs @ c2w[:3, :3].T
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), viewdirs.reshape(-1, 3)


def ray_sphere_bounds(ray_o: torch.Tensor, viewdir: torch.Tensor,
                      near: float, far: float, radius: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray ``[t0, t1]`` where the ray crosses the origin-centred
    sphere of ``radius``, clipped to ``[near, far]`` with ``t1 >= t0``.
    A ray that misses keeps the degenerate ``[near, near + eps]``, so the
    batch shape never changes (``codenerf_tpu/core/rays.py``)."""
    b = torch.sum(ray_o * viewdir, dim=-1)
    disc = b * b - (torch.sum(ray_o * ray_o, dim=-1) - radius * radius)
    hit = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = torch.clamp(-b - sq, near, far)
    t1 = torch.clamp(-b + sq, near, far)
    eps = 1e-3 * (far - near)
    t0 = torch.where(hit, t0, torch.full_like(t0, near))
    t1 = torch.where(hit, torch.maximum(t1, t0 + eps),
                     torch.full_like(t1, near + eps))
    return t0, t1


def pixel_rays(uv: torch.Tensor, focal: torch.Tensor, c2w: torch.Tensor,
               H: float, W: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for a batch of (pixel, pose, focal) triples — the training
    path. ``uv (..., 2)`` holds FULL-image pixel coordinates (u = column,
    v = row; a center crop keeps the principal point, so a cropped pixel's
    ray is the same pixel's ray in the full image), ``focal (...,)``,
    ``c2w (..., 3, 4)`` or ``(..., 4, 4)``. Returns (origins (..., 3), unit
    viewdirs (..., 3)) float32."""
    c2w = c2w.float()
    u, v = uv[..., 0].float(), uv[..., 1].float()
    focal = focal.float()
    dirs = torch.stack([(u - W * 0.5) / focal, -(v - H * 0.5) / focal,
                        -torch.ones_like(u)], dim=-1)
    rays_d = torch.einsum("...rc,...c->...r", c2w[..., :3, :3], dirs)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[..., :3, 3].expand(rays_d.shape)
    return rays_o, viewdirs
