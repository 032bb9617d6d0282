"""Per-ray prologue of the fused kernels, and the plain in-tile composite.

Counterpart of the host-side half of ``codenerf_tpu/ops/fused_mlp.py``:

- :func:`prep_ray_operands` — per-RAY precompute in plain PyTorch
  (differentiable): lane-padded origins/directions, f32 z, the per-ray
  code projections ``relu(code @ W_z + b)`` (R, blocks, W) bf16, and the
  per-ray viewdir contribution of the enc_viewdir weight split — rows
  ``[:W]`` act on the trunk inside the kernel, rows ``[W:]`` plus the bias
  act on PE(viewdir) here (``vcontrib`` (R, W) bf16).
- :func:`pe_consts` — the 64-lane positional-encoding constants
  (``t = xyz8 @ A``; ``pe = m_id·t + m_sin·sin t + m_cos·cos t``).
- :func:`composite_fwd_in_kernel` / :func:`composite_bwd_in_kernel` — the
  in-tile volume rendering forward and backward of the single-pass kernel,
  in plain f32 PyTorch. The TPU spelled the exclusive transmittance as a
  log-space triangular (S, S) matmul for its matrix unit; the natural
  spelling here (and in the CUDA kernel, a per-ray warp scan) is an
  exclusive cumulative product. Same math to f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.core.encoding import positional_encoding


def pad_lanes(x: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - x.shape[-1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(*x.shape[:-1], pad)], dim=-1)


def pe_consts(num_freqs: int):
    """(A (8, 64), m_id, m_sin, m_cos (64,)) float32 numpy arrays; channel
    order of :func:`core.encoding.positional_encoding`, padding lanes 0."""
    F = num_freqs
    A = np.zeros((8, 64), np.float32)
    m_id = np.zeros((64,), np.float32)
    m_sin = np.zeros((64,), np.float32)
    m_cos = np.zeros((64,), np.float32)
    for c in range(3 + 6 * F):
        if c < 3:
            A[c, c] = 1.0
            m_id[c] = 1.0
        elif c < 3 + 3 * F:
            i, d = divmod(c - 3, 3)
            A[d, c] = 2.0 ** i
            m_sin[c] = 1.0
        else:
            i, d = divmod(c - 3 - 3 * F, 3)
            A[d, c] = 2.0 ** i
            m_cos[c] = 1.0
    return A, m_id, m_sin, m_cos


def pe_in_kernel(xyz8: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """(P, 8) f32 points -> (P, 64) f32 positional encoding."""
    A, m_id, m_sin, m_cos = (torch.from_numpy(c).to(xyz8.device)
                             for c in pe_consts(num_freqs))
    t = xyz8 @ A
    return m_id * t + m_sin * torch.sin(t) + m_cos * torch.cos(t)


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and accumulation (products of bf16
    values are exact in f32)."""
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def prep_ray_operands(model, cfg: NetConfig, ray_o, viewdir, z_vals,
                      shape_code, texture_code):
    """Returns ``(ro8, vd8, z, sproj, tproj, vcontrib)``; differentiable
    with respect to the codes (and the weights)."""
    bf16 = torch.bfloat16
    R = z_vals.shape[0]
    if shape_code.dim() == 1:
        shape_code = shape_code.expand(R, -1)
    if texture_code.dim() == 1:
        texture_code = texture_code.expand(R, -1)
    ro8 = pad_lanes(ray_o.float(), 8)
    vd8 = pad_lanes(viewdir.float(), 8)
    vd_pe = positional_encoding(viewdir, cfg.num_dir_freq)     # (R, 27)

    def ray_proj(prefix, code, blocks):
        outs = []
        for j in range(blocks):
            lin = getattr(model, f"{prefix}_{j}")
            outs.append(torch.relu(_dot_f32(code, lin.weight.T)
                                   + lin.bias.float()).to(bf16))
        return torch.stack(outs, dim=1)                        # (R, nb, W)

    sproj = ray_proj("shape_latent", shape_code, cfg.shape_blocks)
    tproj = ray_proj("texture_latent", texture_code, cfg.texture_blocks)
    encv = model.enc_viewdir
    vcontrib = (_dot_f32(vd_pe, encv.weight[:, cfg.W:].T)
                + encv.bias.float()).to(bf16)                  # (R, W)
    return ro8, vd8, z_vals.float(), sproj, tproj, vcontrib


def _deltas(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([z[:, 1:] - z[:, :-1],
                      torch.full_like(z[:, :1], 1e10)], dim=-1)


def composite_fwd_in_kernel(sig, c0, c1, c2, z, white_bg: bool):
    """All inputs (T, S) f32. Returns ``(out8 (T, 8), aux)`` with out8 =
    ``[r | g | b | depth | acc | 0 0 0]``."""
    delta = _deltas(z)
    e = torch.exp(-sig * delta)          # 1 - alpha
    a = 1.0 - e
    u = e + 1e-10                        # reference 1e-10 floor
    Tacc = torch.cat([torch.ones_like(u[:, :1]),
                      torch.cumprod(u[:, :-1], dim=-1)], dim=-1)
    w = a * Tacc
    acc = w.sum(-1)
    rgb = torch.stack([(w * c).sum(-1) for c in (c0, c1, c2)], dim=-1)
    if white_bg:
        rgb = (rgb + 1.0) - acc[:, None]
    zeros = torch.zeros_like(rgb)
    out8 = torch.cat([rgb, (w * z).sum(-1, keepdim=True), acc[:, None],
                      zeros], dim=-1)
    return out8, (delta, e, u, Tacc, w)


def composite_bwd_in_kernel(sig, c0, c1, c2, z, g8, aux, white_bg: bool):
    """Backward of :func:`composite_fwd_in_kernel` for the per-ray
    cotangent ``g8 (T, 8)``: ``(gsig, gc0, gc1, gc2, dz)``, (T, S) f32,
    with ``dx = e·(T·dw − dL/u)`` for ``x = sig·delta``."""
    delta, e, u, Tacc, w = aux
    S = z.shape[1]
    gr, gg, gb = g8[:, 0:1], g8[:, 1:2], g8[:, 2:3]
    gd, ga = g8[:, 3:4], g8[:, 4:5]
    resid = ga - (gr + gg + gb) if white_bg else ga
    dw = gr * c0 + gg * c1 + gb * c2 + gd * z + resid
    suffix = torch.flip(torch.cumsum(torch.flip(w * dw, [1]), 1), [1])
    dL = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], 1)
    dx = e * (Tacc * dw - dL / u)
    gsig = dx * delta
    lane = torch.arange(S, device=z.device)[None, :]
    ddelta = torch.where(lane < S - 1, dx * sig, torch.zeros_like(dx))
    dz = (gd * w + torch.cat([torch.zeros_like(ddelta[:, :1]),
                              ddelta[:, :-1]], 1) - ddelta)
    return gsig, w * gr, w * gg, w * gb, dz
