"""Occupancy-grid empty-space skipping, with static shapes (counterpart of
``codenerf_tpu/core/occupancy.py``).

A binary occupancy grid over the box ``[-radius, radius]^3`` lets each
ray keep its fixed ``n_samples`` budget but shrink its ``[t0, t1]`` to
the occupied span: ``ray_grid_bounds`` probes ``M`` equidistant points per
ray, looks up their cells, and tightens to [first occupied probe − h,
last occupied probe + h] (h the probe spacing). Rays with no occupied
probe keep the degenerate ``[t0, t0 + eps]`` and composite to background.

The grid comes from sigma at the G³ cell centres (sigma does not depend
on the view direction in CodeNeRF, so one evaluation per cell is exact),
thresholded, masked to the bounding sphere and dilated by one cell. In
training it is a category-level density field: a max-union over every
object's codes (``category_density_scan``), refreshed round-robin with an
EMA decay (``update_density_grid``). The density is a pure function of
the model and codes and is not checkpointed.

On a GPU the cell lookup is a direct index gather; the JAX package's
column gather with a one-hot reduce is a TPU workaround with the same
bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from codenerf_tpu_torch.core.sampling import f32_value, lerp_linspace


class OccupancyGrid(NamedTuple):
    """``occ`` (G, G, G) bool over ``[-radius, radius]^3``."""

    occ: torch.Tensor
    radius: float


def grid_cell_centers(G: int, radius: float, device=None) -> torch.Tensor:
    """(G³, 3) cell centres, C order; world component k is grid axis k."""
    edges = lerp_linspace(-radius, radius, G + 1, device=device)
    c = 0.5 * (edges[:-1] + edges[1:])
    c0, c1, c2 = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([c0, c1, c2], dim=-1).reshape(-1, 3)


def dilate_grid(occ: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary dilation by a 3³ neighbourhood: max-pool, stride 1, padding
    1 (PyTorch pads a max-pool with −inf, as JAX's SAME window does)."""
    x = occ.float()[None, None]
    for _ in range(iterations):
        x = torch.nn.functional.max_pool3d(x, 3, stride=1, padding=1)
    return x[0, 0] > 0.0


@torch.no_grad()
def eval_sigma_grid(model, shape_code: torch.Tensor,
                    texture_code: torch.Tensor, G: int, radius: float,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Sigma at the G³ cell centres for ONE object's codes, (G, G, G)
    f32, through the plain ``CodeNeRF`` forward (rays = G², samples = G)."""
    dev = shape_code.device
    xyz = grid_cell_centers(G, radius, dev).reshape(G * G, G, 3)
    viewdir = torch.zeros(G * G, 3, device=dev)
    viewdir[:, 2] = -1.0
    sigmas, _ = model(xyz, viewdir, shape_code, texture_code,
                      compute_dtype=compute_dtype)
    return sigmas.reshape(G, G, G).float()


def grid_from_density(density: torch.Tensor, radius: float,
                      sigma_threshold: float = 0.01, dilate: int = 1,
                      mask_radius: Optional[float] = None) -> OccupancyGrid:
    """Threshold a (G, G, G) sigma field (raw softplus units). Cells
    outside the origin-centred sphere of ``mask_radius`` are empty: no
    training ray crossed them, so their density means nothing."""
    G = density.shape[0]
    occ = density >= sigma_threshold
    if mask_radius is not None:
        c = grid_cell_centers(G, radius, density.device)
        r = torch.sqrt(torch.sum(c * c, dim=-1)).reshape(G, G, G)
        occ = occ & (r <= mask_radius)
    if dilate > 0:
        occ = dilate_grid(occ, dilate)
    return OccupancyGrid(occ=occ, radius=float(radius))


def full_grid(G: int, radius: float, device=None) -> OccupancyGrid:
    """All cells occupied: the training warm-up's grid."""
    return OccupancyGrid(torch.ones((G, G, G), dtype=torch.bool,
                                    device=device), float(radius))


@torch.no_grad()
def update_density_grid(density: torch.Tensor, model,
                        shape_codes: torch.Tensor,
                        texture_codes: torch.Tensor, radius: float,
                        decay: float = 0.99,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``max(decay · density, max over the given codes of sigma)``: the
    EMA-union refresh, one object's sigma field at a time."""
    G = density.shape[0]
    sig = None
    for sc, tc in zip(shape_codes, texture_codes):
        s = eval_sigma_grid(model, sc, tc, G, radius, compute_dtype)
        sig = s if sig is None else torch.maximum(sig, s)
    return torch.maximum(density * decay, sig)


def resolve_codes_per_update(occ_cfg, n_objects: int,
                             retention: float = 0.5, k_min: int = 8) -> int:
    """``codes_per_update``, or when it is None the smallest k >= k_min
    whose round-robin cycle keeps ``decay^rounds >= retention``."""
    if occ_cfg.codes_per_update is not None:
        return min(int(occ_cfg.codes_per_update), n_objects)
    decay = float(occ_cfg.decay)
    if decay >= 1.0:
        return min(k_min, n_objects)
    max_rounds = max(1, int(math.floor(math.log(retention)
                                       / math.log(decay))))
    k = max(k_min, -(-n_objects // max_rounds))
    return min(k, n_objects)


@torch.no_grad()
def category_density_scan(model, shape_codes: torch.Tensor,
                          texture_codes: torch.Tensor, grid_size: int,
                          radius: float, codes_per_chunk: int,
                          sigma_threshold: float = 0.01, dilate: int = 1,
                          compute_dtype=torch.bfloat16
                          ) -> Tuple[torch.Tensor, OccupancyGrid]:
    """The max-union of every object's sigma field (``decay = 1``, so the
    order and the chunking do not change a bit) and its grid, masked to
    the grid's own radius. Returns ``(density, grid)``."""
    n = shape_codes.shape[0]
    k = min(codes_per_chunk, n)
    density = torch.zeros((grid_size,) * 3, dtype=torch.float32,
                          device=shape_codes.device)
    for start in range(0, n, k):
        density = update_density_grid(
            density, model, shape_codes[start:start + k],
            texture_codes[start:start + k], radius, decay=1.0,
            compute_dtype=compute_dtype)
    grid = grid_from_density(density, radius,
                             sigma_threshold=sigma_threshold, dilate=dilate,
                             mask_radius=radius)
    return density, grid


def rebuild_category_grid(model, shape_codes: torch.Tensor,
                          texture_codes: torch.Tensor, occ_cfg,
                          radius: float,
                          compute_dtype=torch.bfloat16) -> OccupancyGrid:
    """The category grid of a ``TrainOccupancyConfig`` from a model and its
    code tables: what the optimize CLI's ``--opt_occ`` rebuilds from a
    checkpoint."""
    _, grid = category_density_scan(
        model, shape_codes, texture_codes, occ_cfg.grid_size, float(radius),
        resolve_codes_per_update(occ_cfg, shape_codes.shape[0]),
        sigma_threshold=occ_cfg.sigma_threshold, dilate=occ_cfg.dilate,
        compute_dtype=compute_dtype)
    return grid


def build_occupancy_grid(model, shape_code: torch.Tensor,
                         texture_code: torch.Tensor, G: int = 64,
                         radius: float = 1.0, sigma_threshold: float = 0.01,
                         dilate: int = 1, compute_dtype=torch.bfloat16,
                         mask_radius: Optional[float] = None
                         ) -> OccupancyGrid:
    """One object's grid (the render-side entry point)."""
    density = eval_sigma_grid(model, shape_code, texture_code, G, radius,
                              compute_dtype)
    return grid_from_density(density, radius,
                             sigma_threshold=sigma_threshold, dilate=dilate,
                             mask_radius=mask_radius)


def _cell_index(grid: OccupancyGrid, pts: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points (..., 3) -> per-axis cell indices (..., 3), clipped to
    the grid, and an inside-the-box mask (...,)."""
    G = grid.occ.shape[0]
    r = f32_value(grid.radius)          # the f32 radius; 2r is exact too
    u = (pts + r) / (2.0 * r) * G
    idx = torch.clamp(torch.floor(u).long(), 0, G - 1)
    inside = torch.all((pts >= -r) & (pts <= r), dim=-1)
    return idx, inside


def occupancy_at(grid: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    """Occupancy at world points (..., 3); outside the box is empty."""
    idx, inside = _cell_index(grid, pts)
    return grid.occ[idx[..., 0], idx[..., 1], idx[..., 2]] & inside


def ray_grid_bounds(grid: OccupancyGrid, ray_o: torch.Tensor,
                    viewdir: torch.Tensor, t0: torch.Tensor,
                    t1: torch.Tensor, n_probes: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tighten per-ray ``[t0, t1]`` (R,) to the occupied span: ``n_probes``
    equidistant probes, [first occupied − h, last occupied + h] clipped
    to the incoming interval; ``[t0, t0 + eps]`` for a ray with none."""
    M = n_probes
    frac = lerp_linspace(0.0, 1.0, M, device=t0.device)
    ts = t0[:, None] + frac[None, :] * (t1 - t0)[:, None]          # (R, M)
    pts = ray_o[:, None, :] + viewdir[:, None, :] * ts[..., None]
    occ = occupancy_at(grid, pts)                                   # (R, M)
    hit = torch.any(occ, dim=-1)
    # the first index of the largest value, as jnp.argmax picks it
    lane = torch.arange(M, device=occ.device)
    first = torch.where(occ, lane, M).min(dim=-1).values.clamp(max=M - 1)
    last = torch.where(occ, lane, -1).max(dim=-1).values.clamp(min=0)
    h = (t1 - t0) / max(M - 1.0, 1.0)
    t_lo = torch.gather(ts, 1, first[:, None])[:, 0] - h
    t_hi = torch.gather(ts, 1, last[:, None])[:, 0] + h
    t_lo = torch.minimum(torch.maximum(t_lo, t0), t1)
    t_hi = torch.minimum(torch.maximum(t_hi, t0), t1)
    eps = 1e-3 * torch.clamp(torch.max(t1 - t0), min=1e-6)
    new_t0 = torch.where(hit, t_lo, t0)
    new_t1 = torch.where(hit, torch.maximum(t_hi, t_lo + eps), t0 + eps)
    return new_t0, new_t1
