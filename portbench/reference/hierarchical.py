"""Plain hierarchical CodeNeRF: NeRF's coarse-to-fine sampling with a
separate fine network (Mildenhall et al., ECCV 2020, arXiv:2003.08934
§5.2-5.3), in float32 with TF32 off, or with fp8 products for the
control. Only a served render's deterministic path: ``Nc`` coarse depths
evenly spaced over ``[near, far]``, the coarse network and its
compositing weights, ``Nf`` inverse-CDF depths drawn from them
(:func:`sample_pdf`, NeRF's ``det=True``), the sorted union of all
``Nc + Nf`` depths, the fine network there and the composite on white.
The networks and the composite are ``codenerf.py``'s.

The benchmark's reference, which the port's CPU tests use too
(``tests/test_torch_render_hier_route.py``). It imports neither the
program under test, the JAX package nor JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import codenerf as ref


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
               uniform: bool = False) -> torch.Tensor:
    """NeRF's ``sample_pdf`` with ``det=True`` (``run_nerf_helpers.py``):
    ``n`` depths (R, n) at evenly spaced probes of the inverse CDF of the
    piecewise-constant pdf of ``weights`` (R, M) over the bin edges
    ``bins`` (R, M + 1). ``uniform`` draws them as if every weight were
    equal: the planted fault ``uniform_fine``.

    Departures from the published sampler, as the program's
    ``core/sampling.py`` samples:

    - the probes are ``linspace(0, 1 - 1e-5)``, not ``linspace(0, 1)``;
    - a CDF step under 1e-8, not 1e-5, counts as empty (denominator 1);
    - the caller passes the interior weights ``[1:-1]`` over the
      midpoints of the coarse depths (as NeRF's ``render_rays`` does);
    - 1e-5 is added to the weights before they are normalised (NeRF adds
      it too, and only then builds the pdf)."""
    weights = weights + 1e-5
    if uniform:
        weights = torch.ones_like(weights)
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    R = cdf.shape[0]
    u = torch.linspace(0.0, 1.0 - 1e-5, n, device=cdf.device)
    u = u.expand(R, n).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below, cdf_above = cdf.gather(1, below), cdf.gather(1, above)
    bins_below, bins_above = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def render_rays(coarse: dict, fine: dict, hp: dict, ro: torch.Tensor,
                vd: torch.Tensor, shape_code: torch.Tensor,
                texture_code: torch.Tensor, prec: ref.Precision,
                uniform_fine: bool = False) -> torch.Tensor:
    """The fine pass's colour (R, 3) of rays ``ro``, ``vd`` (R, 3); codes
    (D,), shared by both networks; ``hp`` with ``net_hyperparams``,
    ``N_samples``, ``N_importance``, ``near`` and ``far``."""
    net, R = hp["net_hyperparams"], ro.shape[0]
    sc, tc = shape_code.expand(R, -1), texture_code.expand(R, -1)
    z = torch.linspace(hp["near"], hp["far"], hp["N_samples"],
                       device=ro.device).expand(R, -1)
    sigma, rgb = ref.forward(coarse, net, ro[:, None] + vd[:, None]
                             * z[..., None], vd, sc, tc, prec)
    w = ref.composite(sigma, rgb, z)[1]
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_fine = sample_pdf(z_mid, w[:, 1:-1], hp["N_importance"], uniform_fine)
    z = torch.sort(torch.cat([z, z_fine], -1), -1).values
    sigma, rgb = ref.forward(fine, net, ro[:, None] + vd[:, None]
                             * z[..., None], vd, sc, tc, prec)
    return ref.composite(sigma, rgb, z)[0]


@torch.no_grad()
def render(coarse: dict, fine: dict, hp: dict, shape_code: torch.Tensor,
           texture_code: torch.Tensor, c2w: np.ndarray, H: int, W: int,
           focal: float, precision: str = "f32", uniform_fine: bool = False,
           chunk: int = 4096) -> np.ndarray:
    """One H×W view from the camera ``c2w`` (4, 4), (H, W, 3) uint8: the
    colour times 255 clipped to [0, 255] and cut to uint8."""
    ref.set_exact_float32()
    prec = ref.Precision(precision)
    dev = shape_code.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], -1)
    focal_t = torch.full((H * W,), float(np.float32(focal)), device=dev)
    c2w_t = torch.from_numpy(c2w).to(dev).expand(H * W, 4, 4)
    ro, vd = ref.pixel_rays(uv, focal_t, c2w_t, H, W)
    img = torch.cat([render_rays(coarse, fine, hp, ro[s:s + chunk],
                                 vd[s:s + chunk], shape_code, texture_code,
                                 prec, uniform_fine)
                     for s in range(0, H * W, chunk)]).reshape(H, W, 3)
    return np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
