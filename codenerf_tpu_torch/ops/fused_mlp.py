"""Per-ray prologue of the fused kernels, and the plain in-tile composite.

Counterpart of the host-side half of ``codenerf_tpu/ops/fused_mlp.py``:

- :func:`prep_ray_operands` — per-RAY precompute in plain PyTorch
  (differentiable): lane-padded origins/directions, f32 z, the per-ray
  code projections ``relu(code @ W_z + b)`` (R, blocks, W) bf16, and the
  per-ray viewdir contribution of the enc_viewdir weight split — rows
  ``[:W]`` act on the trunk inside the kernel, rows ``[W:]`` plus the bias
  act on PE(viewdir) here (``vcontrib`` (R, W) bf16). Its two halves,
  :func:`ray_operands` and :func:`code_operands`, serve a caller whose
  rays share one code (``renderer.render_rays_kernels``).
- :func:`pe_consts` — the 64-lane positional-encoding constants
  (``t = xyz8 @ A``; ``pe = m_id·t + m_sin·sin t + m_cos·cos t``).
- :func:`composite_fwd_in_kernel` / :func:`composite_bwd_in_kernel` — the
  in-tile volume rendering forward and backward of the single-pass kernel,
  in plain f32 PyTorch. The TPU spelled the exclusive transmittance as a
  log-space triangular (S, S) matmul for its matrix unit; the natural
  spelling here (and in the CUDA kernel, a per-ray warp scan) is an
  exclusive cumulative product. Same math to f32 rounding.
  :func:`composite_fwd_dual_in_kernel` / :func:`composite_bwd_dual_in_kernel`
  add the dual mode's coarse composite over the same union samples.
- :func:`sigma_fwd` — the sigma-only forward, replacing
  ``codenerf_tpu/ops/fused_mlp.py::_kernel(sigma_only=True)`` (launched by
  ``invoke_fwd``): the density of every sample, the only output the
  hierarchical coarse pass needs (its compositing weights drive
  ``sample_pdf``). On CUDA tensors it launches ``sigma_step`` of
  ``csrc/train_fused.cu``: the single-pass kernel's own forward,
  ``trunk_fwd_kernel``, from the PE through enc_shape with the
  activations in shared memory (only t reaches device memory), and
  ``sigma_head_kernel``, the four-plane head's loop without its rgb
  lanes (8 points a warp). Bound by operations:
  2W(64 + W(nb+1)) = 557,056 FLOP per point at W=256, nb=3 — 2.92e11 FLOP
  for a 16,384 × 32 training launch (0.30 ms at 989 TFLOP/s dense bf16),
  7.3e10 for a 4096 × 32 optimization chunk (0.074 ms); its inputs and
  output are ~35 MB. :func:`sigma_fwd_plain` is its plain version, and
  ``sigma_fwd.launches["sigma"]`` counts its launches
  (``sigma_fwd.points`` their R·S, ``sigma_fwd.bulk_planes`` the planes
  the trunk stored from its tile by TMA: t, one a launch).
- :func:`planes_fwd` — the four-plane forward, replacing the same TPU
  kernel with ``sigma_only=False`` (the forward of the plane op,
  ``ops/fused_train.py``): sigma (softplus) and the raw r, g, b of every
  sample as (R, S) f32 planes, no composite. On CUDA tensors it launches
  ``planes_step``: ``trunk_fwd_kernel`` through rgb_hidden in one launch
  (t computed as ``sigma_step`` computes it; the epilogues add vcontrib
  and inject the texture latents), then ``plane_head_kernel``: sigma and
  the raw r, g, b in one 16-byte pass over t and r, its sigma lane the
  sigma head's arithmetic, so the sigma plane is ``sigma_fwd``'s, bit for
  bit. Bound
  by operations: 2W(64 + W(nb+nt+2) + W/2) = 884,736 FLOP per point at
  W=256, nb=3, nt=1 — 0.94 ms for a 16,384 × 64 launch at 989 TFLOP/s
  dense bf16, 0.23 ms for 4096 × 64.
  :func:`planes_fwd_plain` is its plain version (:func:`forward_plain`
  is the forward every plain version shares, :func:`plane_head_plain`
  the head's), and
  ``planes_fwd.launches["planes"]`` counts its launches
  (``planes_fwd.points`` their R·S, ``planes_fwd.bulk_planes`` the planes
  stored by TMA: t and r, two a launch).
  :func:`fused_codenerf_apply` runs it from rays, depths and codes.
- :func:`input_chain`, :func:`plane_head` and :func:`sigma_head` — the
  input-chain kernel of the pose modes, the four-plane head and the
  sigma-only head alone, for their checks against
  :func:`input_chain_plain`, :func:`plane_head_plain` and
  :func:`sigma_head_plain` on the card (CUDA tensors only;
  ``input_chain.launches``, ``plane_head.launches``,
  ``sigma_head.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.core.encoding import positional_encoding

# The TPU forward kernel's ray tile. The CUDA kernels do not tile rays
# this way; the port keeps the rule so both packages route alike.
_TILE_RAYS = 32


def fused_available(cfg: NetConfig, n_rays: int, n_samples: int) -> bool:
    """The forward kernel's architecture family (W a multiple of 256, the
    PE within 64 lanes) and the TPU's ray tiling."""
    return (cfg.W % 256 == 0 and cfg.d_xyz <= 64
            and n_rays % _TILE_RAYS == 0
            and (_TILE_RAYS * n_samples) % 16 == 0)


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


def _pe_tensors(num_freqs: int, device):
    return tuple(torch.from_numpy(c).to(device) for c in pe_consts(num_freqs))


def pe_in_kernel(xyz8: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """(P, 8) f32 points -> (P, 64) f32 positional encoding."""
    A, m_id, m_sin, m_cos = _pe_tensors(num_freqs, xyz8.device)
    t = xyz8 @ A
    return m_id * t + m_sin * torch.sin(t) + m_cos * torch.cos(t)


def input_chain_plain(R: int, S: int, ro8, vd8, z, gh0, w_enc, dz_comp,
                      num_freqs: int):
    """The pose modes' input chain (the TPU kernel's ``input_grads`` tail):
    ``d_pe = gh0 @ W_enc^T`` (bf16 operands, f32 sums), the PE Jacobian
    ``dpe/dt = m_id + m_sin·cos t - m_cos·sin t`` at ``t = xyz8 @ A``,
    ``d_xyz = (d_pe·dpe/dt) @ A^T``; then ``d_z = dz_comp + d_xyz·vd``,
    ``d_ro8 = Σ_s d_xyz`` and ``d_vd8 = Σ_s d_xyz·z``. Returns ``(d_ro8
    (R, 8), d_vd8 (R, 8), d_z (R, S))`` f32."""
    A, m_id, m_sin, m_cos = _pe_tensors(num_freqs, z.device)
    xyz8 = (ro8[:, None, :] + vd8[:, None, :] * z[:, :, None]).reshape(-1, 8)
    t = xyz8 @ A
    d_pe = gh0.float() @ w_enc.float().T
    dpe_dt = m_id + m_sin * torch.cos(t) - m_cos * torch.sin(t)
    d_xyz = ((d_pe * dpe_dt) @ A.T).view(R, S, 8)
    d_z = dz_comp + torch.sum(d_xyz * vd8[:, None, :], dim=-1)
    return d_xyz.sum(dim=1), torch.sum(d_xyz * z[:, :, None], dim=1), d_z


def _check_operands(what: str, specs) -> torch.device:
    """Each ``(name, tensor, dtype, shape)`` of a standalone kernel's
    operands: the dtype, the shape, contiguous and 16-byte aligned, all on
    one CUDA device (checked last). Raises ValueError; converts nothing."""
    for name, x, dtype, shape in specs:
        if x.dtype != dtype:
            raise ValueError(f"{what}: {name} has dtype {x.dtype}, expected "
                             f"{dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             f"16-byte aligned")
    dev = specs[0][1].device
    if dev.type != "cuda" or any(x.device != dev for _, x, _, _ in specs):
        raise ValueError(f"{what} launches the CUDA kernel on CUDA tensors "
                         f"of one device; its plain version is "
                         f"{what}_plain")
    return dev


def input_chain(R: int, S: int, ro8, vd8, z, gh0, w_enc, dz_comp,
                num_freqs: int):
    """:func:`input_chain_plain` by the CUDA kernel that ``fused_step``
    runs after the dx chain in every mode with input gradients
    (``input_chain_kernel``), for its check against the plain version on
    the card: ``d_ro8``, ``d_vd8`` and ``d_z`` the same bits on every
    call. CUDA tensors only, contiguous and 16-byte aligned: ``gh0``
    (R·S, 256) and ``w_enc`` (64, 256) bf16, ``ro8``, ``vd8`` (R, 8),
    ``z`` and ``dz_comp`` (R, S) f32; 1 <= S <= 256. Counts its launches
    in ``input_chain.launches``."""
    from codenerf_tpu_torch.ops import fused_train as ft

    if not 1 <= S <= ft._MAX_SAMPLES or R < 1:
        raise ValueError(f"input_chain takes R >= 1 and 1 <= S <= "
                         f"{ft._MAX_SAMPLES}; got R={R}, S={S}")
    if 3 + 6 * num_freqs > 64:
        raise ValueError(f"input_chain takes 3 + 6·num_freqs <= 64 PE "
                         f"lanes; got num_freqs={num_freqs}")
    f32, bf16, W = torch.float32, torch.bfloat16, ft.TRUNK_W
    dev = _check_operands("input_chain", [
        ("gh0", gh0, bf16, (R * S, W)), ("w_enc", w_enc, bf16, (64, W)),
        ("ro8", ro8, f32, (R, 8)), ("vd8", vd8, f32, (R, 8)),
        ("z", z, f32, (R, S)), ("dz_comp", dz_comp, f32, (R, S))])
    lib = ft.library()
    d_z = dz_comp.clone()
    d_ro8 = torch.empty(R, 8, dtype=f32, device=dev)
    d_vd8 = torch.empty(R, 8, dtype=f32, device=dev)
    rc = lib.input_chain_step(
        *[ft._ptr(x) for x in (gh0, w_enc, ro8, vd8, z, d_z, d_ro8, d_vd8)],
        R, S, W, num_freqs,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"input_chain CUDA kernel failed: cudaError {rc}")
    input_chain.launches += 1
    return d_ro8, d_vd8, d_z


input_chain.launches = 0


def plane_head_plain(R: int, S: int, t, r, w_sig, b_sig, w_rgb, b_rgb):
    """The four-plane forward's head from enc_shape's bf16 output ``t``
    (R·S, W) and rgb_hidden's ``r`` (R·S, W/2): ``(sigma, r, g, b)``, each
    (R, S) f32 — ``softplus(t · w_sig + b_sig)`` (the f32 sum of
    :func:`shape_trunk_plain`'s ``sig_pre``) and the raw channels 0..2 of
    ``r @ w_rgb + b_rgb`` (bf16 operands, f32 sums). The TPU kernel's
    heads, ``codenerf_tpu/ops/fused_mlp.py:363-382``."""
    rgb = (r.float() @ w_rgb.float() + b_rgb).view(R, S, -1)
    return (sigma_head_plain(R, S, t, w_sig, b_sig), rgb[..., 0].contiguous(),
            rgb[..., 1].contiguous(), rgb[..., 2].contiguous())


def plane_head(R: int, S: int, t, r, w_sig, b_sig, w_rgb, b_rgb):
    """:func:`plane_head_plain` by the CUDA kernel that ``planes_step``
    runs after the trunk (``plane_head_kernel``), for its check against
    the plain version on the card. CUDA tensors only, contiguous and
    16-byte aligned: ``t`` (R·S, 256), ``r`` (R·S, 128) and ``w_rgb``
    (128, 8) bf16, ``w_sig`` (256,), ``b_sig`` (1,), ``b_rgb`` (8,) f32.
    Counts its launches in ``plane_head.launches``."""
    from codenerf_tpu_torch.ops import fused_train as ft

    f32, bf16, W = torch.float32, torch.bfloat16, ft.TRUNK_W
    if R < 1 or S < 1:
        raise ValueError(f"plane_head takes R, S >= 1; got R={R}, S={S}")
    dev = _check_operands("plane_head", [
        ("t", t, bf16, (R * S, W)), ("r", r, bf16, (R * S, W // 2)),
        ("w_sig", w_sig, f32, (W,)), ("b_sig", b_sig, f32, (1,)),
        ("w_rgb", w_rgb, bf16, (W // 2, 8)), ("b_rgb", b_rgb, f32, (8,))])
    lib = ft.library()
    planes = [torch.empty(R, S, dtype=f32, device=dev) for _ in range(4)]
    rc = lib.plane_head_step(
        *[ft._ptr(x) for x in (t, r, w_sig, b_sig, w_rgb, b_rgb, *planes)],
        R, S, W, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"plane_head CUDA kernel failed: cudaError {rc}")
    plane_head.launches += 1
    return tuple(planes)


plane_head.launches = 0


def sigma_head_plain(R: int, S: int, t, w_sig, b_sig):
    """The sigma-only forward's head from enc_shape's bf16 output ``t``
    (R·S, W): ``softplus(t · w_sig + b_sig)``, (R, S) f32, the f32 sum of
    :func:`shape_trunk_plain`'s ``sig_pre`` — the TPU kernel's sigma head,
    ``codenerf_tpu/ops/fused_mlp.py:362-368``. :func:`plane_head_plain`'s
    sigma plane."""
    return softplus((t.float() * w_sig[None, :]).sum(-1).view(R, S)
                    + b_sig[0])


def sigma_head(R: int, S: int, t, w_sig, b_sig):
    """:func:`sigma_head_plain` by the CUDA kernel that ``sigma_step`` runs
    after the trunk (``sigma_head_kernel``, the sigma lane of
    ``plane_head_kernel``), for its check against the plain version on
    the card. CUDA tensors only, contiguous and 16-byte aligned: ``t``
    (R·S, 256) bf16, ``w_sig`` (256,), ``b_sig`` (1,) f32. Counts its
    launches in ``sigma_head.launches``."""
    from codenerf_tpu_torch.ops import fused_train as ft

    f32, W = torch.float32, ft.TRUNK_W
    if R < 1 or S < 1:
        raise ValueError(f"sigma_head takes R, S >= 1; got R={R}, S={S}")
    dev = _check_operands("sigma_head", [
        ("t", t, torch.bfloat16, (R * S, W)), ("w_sig", w_sig, f32, (W,)),
        ("b_sig", b_sig, f32, (1,))])
    lib = ft.library()
    sigma = torch.empty(R, S, dtype=f32, device=dev)
    rc = lib.sigma_head_step(
        *[ft._ptr(x) for x in (t, w_sig, b_sig, sigma)], R, S, W,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"sigma_head CUDA kernel failed: cudaError {rc}")
    sigma_head.launches += 1
    return sigma


sigma_head.launches = 0


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and accumulation (products of bf16
    values are exact in f32)."""
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def code_operands(model, cfg: NetConfig, shape_code, texture_code):
    """The code projections ``(sproj, tproj)`` of code rows (n, latent):
    ``relu(code @ W_z + b)`` per block, (n, blocks, W) bf16."""
    bf16 = torch.bfloat16

    def proj(prefix, code, blocks):
        outs = []
        for j in range(blocks):
            lin = getattr(model, f"{prefix}_{j}")
            outs.append(torch.relu(_dot_f32(code, lin.weight.T)
                                   + lin.bias.float()).to(bf16))
        return torch.stack(outs, dim=1)                        # (n, nb, W)

    return (proj("shape_latent", shape_code, cfg.shape_blocks),
            proj("texture_latent", texture_code, cfg.texture_blocks))


def ray_operands(model, cfg: NetConfig, ray_o, viewdir):
    """``(ro8, vd8, vcontrib)`` of rays (R, 3): lane-padded origins and
    directions, and the viewdir contribution (R, W) bf16."""
    ro8 = pad_lanes(ray_o.float(), 8)
    vd8 = pad_lanes(viewdir.float(), 8)
    vd_pe = positional_encoding(viewdir, cfg.num_dir_freq)     # (R, 27)
    encv = model.enc_viewdir
    vcontrib = (_dot_f32(vd_pe, encv.weight[:, cfg.W:].T)
                + encv.bias.float()).to(torch.bfloat16)        # (R, W)
    return ro8, vd8, vcontrib


def prep_ray_operands(model, cfg: NetConfig, ray_o, viewdir, z_vals,
                      shape_code, texture_code):
    """Returns ``(ro8, vd8, z, sproj, tproj, vcontrib)``; differentiable
    with respect to the codes (and the weights)."""
    R = z_vals.shape[0]
    if shape_code.dim() == 1:
        shape_code = shape_code.expand(R, -1)
    if texture_code.dim() == 1:
        texture_code = texture_code.expand(R, -1)
    ro8, vd8, vcontrib = ray_operands(model, cfg, ray_o, viewdir)
    sproj, tproj = code_operands(model, cfg, shape_code, texture_code)
    return ro8, vd8, z_vals.float(), sproj, tproj, vcontrib


class TrunkOperands(NamedTuple):
    """One network's weight operands for the kernels, as
    ``fused_train.trunk_operands`` caches them once per weight version
    (or ``fused_train.fresh_trunk_operands`` builds them): ``wops``, the
    :func:`kernel_operands` of ``fused_train.flatten_params`` (16-byte
    aligned, no gradient), and ``packed``, the trunk kernels' packed
    weights (``fused_train.pack_trunk_weights``) on the card — None on the
    CPU, where the plain versions never read it. Every kernel wrapper on
    CUDA tensors takes its weights as one of these."""
    wops: List[torch.Tensor]
    packed: Optional[torch.Tensor]


def kernel_operands(weights) -> List[torch.Tensor]:
    """2-D weights bf16, 1-D weights and biases f32, all contiguous — the
    dtypes the TPU kernels received (``wops`` in ``invoke_train_fused``,
    ``wb`` in ``invoke_fwd``) — of the ``flatten_params`` list
    ``weights``; of a :class:`TrunkOperands`, its own ``wops``."""
    if isinstance(weights, TrunkOperands):
        return weights.wops
    return [(w.to(torch.bfloat16) if w.dim() == 2 else w.float()).contiguous()
            for w in weights]


def shape_trunk_plain(cfg: NetConfig, R: int, S: int, ro8, vd8, z, sproj,
                      wops) -> Dict[str, torch.Tensor]:
    """The kernels' forward up to the sigma pre-activation, rounding where
    the TPU kernels round: PE(xyz) to bf16, bf16 activations after each
    ReLU, the latent injection as a bf16 add, enc_shape's output ``t``
    rounded to bf16 before the f32 sigma dot. ``wops`` in
    ``fused_train.flatten_params`` order and :func:`kernel_operands`
    dtypes. Returns the bf16 ``pe``, ``y0`` (enc_xyz), ``xs`` (each shape
    block's injected input), ``ys`` (its output), ``t``, and ``sig_pre``
    (R, S) f32."""
    bf16 = torch.bfloat16
    P, nb = R * S, cfg.shape_blocks

    def dense(x, i):     # bf16 (P, A) @ bf16 (A, B), f32 sums, + f32 bias
        return x.float() @ wops[2 * i].float() + wops[2 * i + 1]

    xyz8 = (ro8[:, None, :] + vd8[:, None, :] * z[:, :, None]).reshape(P, 8)
    pe = pe_in_kernel(xyz8, cfg.num_xyz_freq).to(bf16)
    y0 = torch.relu(dense(pe, 0)).to(bf16)
    xs, ys, cur = [], [], y0
    for j in range(nb):
        xs.append((cur.view(R, S, -1).float() + sproj[:, j][:, None, :].float()
                   ).to(bf16).view(P, -1))
        cur = torch.relu(dense(xs[j], 1 + j)).to(bf16)
        ys.append(cur)
    t = dense(cur, nb + 1).to(bf16)
    w_sig, b_sig = wops[2 * (nb + 2)], wops[2 * (nb + 2) + 1]
    sig_pre = (t.float() * w_sig[None, :]).sum(-1).view(R, S) + b_sig[0]
    return {"pe": pe, "y0": y0, "xs": xs, "ys": ys, "t": t,
            "sig_pre": sig_pre}


def texture_branch_plain(cfg: NetConfig, R: int, S: int, t, tproj,
                         vcontrib, wops) -> Dict[str, torch.Tensor]:
    """The kernels' forward from enc_shape's bf16 output ``t`` on: the
    enc_viewdir trunk rows plus the per-ray ``vcontrib`` and a ReLU
    (``yv``), each texture block's injected input (``xts``) and output
    (``yts``), the bf16 rgb_hidden output ``r`` and the f32 rgb_out rows
    ``rgb`` (P, 8), rounding where the TPU kernels round."""
    bf16 = torch.bfloat16
    P, W, nb, nt = R * S, cfg.W, cfg.shape_blocks, cfg.texture_blocks
    i_encv, i_tex, i_rgbh = nb + 3, nb + 4, nb + nt + 4

    def dense(x, i):
        return x.float() @ wops[2 * i].float() + wops[2 * i + 1]

    u = t.float() @ wops[2 * i_encv].float()
    yv = torch.relu(u.view(R, S, W) + vcontrib[:, None, :].float()
                    ).view(P, W).to(bf16)
    xts, yts, cur = [], [], yv
    for j in range(nt):
        xts.append((cur.view(R, S, W).float() + tproj[:, j][:, None, :].float()
                    ).to(bf16).view(P, W))
        cur = torch.relu(dense(xts[j], i_tex + j)).to(bf16)
        yts.append(cur)
    r = torch.relu(dense(cur, i_rgbh)).to(bf16)
    return {"yv": yv, "xts": xts, "yts": yts, "r": r,
            "rgb": dense(r, i_rgbh + 1)}


def forward_plain(cfg: NetConfig, R: int, S: int, ro8, vd8, z, sproj, tproj,
                  vcontrib, wops) -> Dict[str, torch.Tensor]:
    """The whole forward of the kernels: :func:`shape_trunk_plain`'s
    activations and :func:`texture_branch_plain`'s, in one dict."""
    acts = shape_trunk_plain(cfg, R, S, ro8, vd8, z, sproj, wops)
    acts.update(texture_branch_plain(cfg, R, S, acts["t"], tproj, vcontrib,
                                     wops))
    return acts


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def sigma_fwd(cfg: NetConfig, S: int, R: int, ro8, vd8, z, sproj, tproj,
              vcontrib, weights) -> torch.Tensor:
    """Counterpart of ``invoke_fwd(..., sigma_only=True)``: the density
    ``softplus(t · w_sig + b_sig)`` of every sample, (R, S) f32. The
    operands are those of ``fused_train.train_fused`` (``tproj``,
    ``vcontrib`` and the texture-branch weights are not read), ``weights``
    included: a :class:`TrunkOperands`, whose packed operands the kernel
    reads, or on CPU tensors also a ``flatten_params`` list.

    On CPU tensors this is :func:`sigma_fwd_plain`; on CUDA tensors it
    launches the CUDA kernel and counts the launch in
    ``sigma_fwd.launches["sigma"]``."""
    if z.shape != (R, S):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {(R, S)}")
    if z.device.type == "cpu":
        return sigma_fwd_plain(cfg, S, R, ro8, vd8, z, sproj, tproj,
                               vcontrib, weights)
    if z.device.type != "cuda":
        raise ValueError(f"sigma_fwd: unsupported device {z.device}")
    out = _launch_sigma_cuda(cfg, S, R, ro8, vd8, z, sproj, weights)
    sigma_fwd.launches["sigma"] += 1
    sigma_fwd.points["sigma"] += R * S
    sigma_fwd.bulk_planes["sigma"] += _bulk_planes()
    return out


sigma_fwd.launches = {"sigma": 0}
sigma_fwd.points = {"sigma": 0}
sigma_fwd.bulk_planes = {"sigma": 0}


def _bulk_planes() -> int:
    """The planes the last forward launch of this thread stored by TMA
    from the trunk kernel's tile."""
    from codenerf_tpu_torch.ops import fused_train as ft

    return ft.library().forward_bulk_planes()


def sigma_fwd_plain(cfg: NetConfig, S: int, R: int, ro8, vd8, z, sproj,
                    tproj, vcontrib, weights) -> torch.Tensor:
    """:func:`sigma_fwd` in plain PyTorch (the CPU tests and
    ``chip_smoke.py``'s comparison use it)."""
    trunk = shape_trunk_plain(cfg, R, S, ro8, vd8, z.float(), sproj,
                              kernel_operands(weights))
    return softplus(trunk["sig_pre"])


def _launch_sigma_cuda(cfg, S, R, ro8, vd8, z, sproj, weights):
    from codenerf_tpu_torch.ops import fused_train as ft

    lib = ft.library()
    dev = z.device
    f32, bf16 = torch.float32, torch.bfloat16
    W, nb = cfg.W, cfg.shape_blocks
    if W != ft.TRUNK_W or not ft.single_pass_available(cfg, R):
        raise ValueError(f"sigma_fwd: the CUDA kernels take W == "
                         f"{ft.TRUNK_W}, d_xyz <= 64 and R % 16 == 0; got "
                         f"W={W}, R={R}")
    ins = dict(ro8=ft._aligned(ro8, f32), vd8=ft._aligned(vd8, f32),
               z=ft._aligned(z, f32), sproj=ft._aligned(sproj, bf16))
    expect = dict(ro8=(R, 8), vd8=(R, 8), z=(R, S), sproj=(R, nb, W))
    for name, x in ins.items():
        if tuple(x.shape) != expect[name] or x.device != dev:
            raise ValueError(f"sigma_fwd: {name} is {tuple(x.shape)} on "
                             f"{x.device}, expected {expect[name]} on {dev}")
    wops, packed = ft._cuda_trunk(cfg, weights, dev)
    nt = cfg.texture_blocks
    ws = torch.empty(lib.forward_workspace(R, S, W, nb, nt, 0), dtype=bf16,
                     device=dev)
    sigma = torch.empty(R, S, dtype=f32, device=dev)
    wptrs, _keep = ft._ptr_array(wops)
    rc = lib.sigma_step(
        ft._ptr(ins["ro8"]), ft._ptr(ins["vd8"]), ft._ptr(ins["z"]),
        ft._ptr(ins["sproj"]), wptrs, ft._ptr(packed), ft._ptr(ws),
        ft._ptr(sigma), R, S, W, nb, nt, cfg.num_xyz_freq,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"sigma_fwd CUDA kernel failed: cudaError {rc}")
    return sigma


def planes_fwd(cfg: NetConfig, S: int, R: int, ro8, vd8, z, sproj, tproj,
               vcontrib, weights):
    """Counterpart of ``invoke_fwd`` (four planes): ``(sigma, r, g, b)``,
    each (R, S) f32 — sigma with softplus applied, the rgb raw (the
    reference applies no sigmoid). Operands, ``weights`` included, as for
    :func:`sigma_fwd`.

    On CPU tensors this is :func:`planes_fwd_plain`; on CUDA tensors it
    launches the CUDA kernel and counts the launch in
    ``planes_fwd.launches["planes"]``."""
    if z.shape != (R, S):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {(R, S)}")
    if z.device.type == "cpu":
        return planes_fwd_plain(cfg, S, R, ro8, vd8, z, sproj, tproj,
                                vcontrib, weights)
    if z.device.type != "cuda":
        raise ValueError(f"planes_fwd: unsupported device {z.device}")
    out = _launch_planes_cuda(cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib,
                              weights)
    planes_fwd.launches["planes"] += 1
    planes_fwd.points["planes"] += R * S
    planes_fwd.bulk_planes["planes"] += _bulk_planes()
    return out


planes_fwd.launches = {"planes": 0}
planes_fwd.points = {"planes": 0}
planes_fwd.bulk_planes = {"planes": 0}


def planes_fwd_plain(cfg: NetConfig, S: int, R: int, ro8, vd8, z, sproj,
                     tproj, vcontrib, weights):
    """:func:`planes_fwd` in plain PyTorch."""
    wops = kernel_operands(weights)
    acts = forward_plain(cfg, R, S, ro8, vd8, z.float(), sproj, tproj,
                         vcontrib, wops)
    i_sig, i_rgbo = cfg.shape_blocks + 2, (cfg.shape_blocks
                                           + cfg.texture_blocks + 5)
    return plane_head_plain(R, S, acts["t"], acts["r"], wops[2 * i_sig],
                            wops[2 * i_sig + 1], wops[2 * i_rgbo],
                            wops[2 * i_rgbo + 1])


def _launch_planes_cuda(cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib,
                        weights):
    from codenerf_tpu_torch.ops import fused_train as ft

    lib = ft.library()
    dev = z.device
    f32, bf16 = torch.float32, torch.bfloat16
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    if W != ft.TRUNK_W or not ft.single_pass_available(cfg, R):
        raise ValueError(f"planes_fwd: the CUDA kernels take W == "
                         f"{ft.TRUNK_W}, d_xyz <= 64 and R % 16 == 0; got "
                         f"W={W}, R={R}")
    ins = dict(ro8=ft._aligned(ro8, f32), vd8=ft._aligned(vd8, f32),
               z=ft._aligned(z, f32), sproj=ft._aligned(sproj, bf16),
               tproj=ft._aligned(tproj, bf16),
               vcontrib=ft._aligned(vcontrib, bf16))
    expect = dict(ro8=(R, 8), vd8=(R, 8), z=(R, S), sproj=(R, nb, W),
                  tproj=(R, nt, W), vcontrib=(R, W))
    for name, x in ins.items():
        if tuple(x.shape) != expect[name] or x.device != dev:
            raise ValueError(f"planes_fwd: {name} is {tuple(x.shape)} on "
                             f"{x.device}, expected {expect[name]} on {dev}")
    wops, packed = ft._cuda_trunk(cfg, weights, dev)
    ws = torch.empty(lib.forward_workspace(R, S, W, nb, nt, 1), dtype=bf16,
                     device=dev)
    planes = [torch.empty(R, S, dtype=f32, device=dev) for _ in range(4)]
    wptrs, _keep = ft._ptr_array(wops)
    rc = lib.planes_step(
        ft._ptr(ins["ro8"]), ft._ptr(ins["vd8"]), ft._ptr(ins["z"]),
        ft._ptr(ins["sproj"]), ft._ptr(ins["tproj"]),
        ft._ptr(ins["vcontrib"]), wptrs, ft._ptr(packed), ft._ptr(ws),
        *[ft._ptr(x) for x in planes], R, S, W, nb, nt, cfg.num_xyz_freq,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"planes_fwd CUDA kernel failed: cudaError {rc}")
    return tuple(planes)


def fused_codenerf_apply(model, cfg: NetConfig, ray_o, viewdir, z_vals,
                         shape_code, texture_code):
    """Counterpart of ``fused_mlp.fused_codenerf_apply``: the four-plane
    forward from rays, depths (R, S) and codes ((R, D) or (D,)), forward
    only. Returns ``(sigmas (R, S), (r, g, b))`` f32 planes."""
    from codenerf_tpu_torch.ops.fused_train import trunk_operands

    R, S = z_vals.shape
    if not fused_available(cfg, R, S):
        raise ValueError(f"fused kernel unsupported for W={cfg.W}, R={R}, "
                         f"S={S}")
    with torch.no_grad():
        ro8, vd8, z, sproj, tproj, vcontrib = prep_ray_operands(
            model, cfg, ray_o, viewdir, z_vals, shape_code, texture_code)
        sig, r, g, b = planes_fwd(cfg, S, R, ro8, vd8, z, sproj, tproj,
                                  vcontrib, trunk_operands(model, cfg))
    return sig, (r, g, b)


def _deltas(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([z[:, 1:] - z[:, :-1],
                      torch.full_like(z[:, :1], 1e10)], dim=-1)


def _composite_fwd(sig, c0, c1, c2, z, delta, floor, white_bg: bool):
    """One composite over the samples' ``delta`` with the cumprod floor
    ``1e-10 · floor``; see :func:`composite_fwd_in_kernel`."""
    e = torch.exp(-sig * delta)          # 1 - alpha
    a = 1.0 - e
    u = e + 1e-10 * floor                # reference 1e-10 floor
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


def composite_fwd_in_kernel(sig, c0, c1, c2, z, white_bg: bool):
    """All inputs (T, S) f32. Returns ``(out8 (T, 8), aux)`` with out8 =
    ``[r | g | b | depth | acc | 0 0 0]``."""
    return _composite_fwd(sig, c0, c1, c2, z, _deltas(z), 1.0, white_bg)


def _composite_grads(c0, c1, c2, z, g8, aux, white_bg: bool):
    """``(gsig, gc0, gc1, gc2, dx)`` of one composite for the per-ray
    cotangent ``g8``, with ``dx = e·(T·dw − dL/u)`` for ``x = sig·delta``."""
    delta, e, u, Tacc, w = aux
    gr, gg, gb = g8[:, 0:1], g8[:, 1:2], g8[:, 2:3]
    gd, ga = g8[:, 3:4], g8[:, 4:5]
    resid = ga - (gr + gg + gb) if white_bg else ga
    dw = gr * c0 + gg * c1 + gb * c2 + gd * z + resid
    suffix = torch.flip(torch.cumsum(torch.flip(w * dw, [1]), 1), [1])
    dL = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], 1)
    dx = e * (Tacc * dw - dL / u)
    return dx * delta, w * gr, w * gg, w * gb, dx


def composite_bwd_in_kernel(sig, c0, c1, c2, z, g8, aux, white_bg: bool):
    """Backward of :func:`composite_fwd_in_kernel` for the per-ray
    cotangent ``g8 (T, 8)``: ``(gsig, gc0, gc1, gc2, dz)``, (T, S) f32."""
    S = z.shape[1]
    gsig, gc0, gc1, gc2, dx = _composite_grads(c0, c1, c2, z, g8, aux,
                                               white_bg)
    gd, w = g8[:, 3:4], aux[4]
    lane = torch.arange(S, device=z.device)[None, :]
    ddelta = torch.where(lane < S - 1, dx * sig, torch.zeros_like(dx))
    dz = (gd * w + torch.cat([torch.zeros_like(ddelta[:, :1]),
                              ddelta[:, :-1]], 1) - ddelta)
    return gsig, gc0, gc1, gc2, dz


def composite_fwd_dual_in_kernel(sig, c0, c1, c2, z, cdelta, cmask,
                                 white_bg: bool):
    """The fine composite over the union samples ``z`` (union deltas,
    terminal 1e10, the unconditional 1e-10 floor) and the coarse one over
    the coarse subset: deltas ``cdelta`` (consecutive-coarse deltas at
    coarse positions, 0 at fine ones) and the floor ``1e-10 · cmask``. At
    a fine position the coarse composite has alpha 0 and a transmittance
    factor of exactly 1.0, so it equals compositing the coarse samples
    alone. Returns ``(out8_fine, out8_coarse, aux)``."""
    out_f, aux_f = _composite_fwd(sig, c0, c1, c2, z, _deltas(z), 1.0,
                                  white_bg)
    out_c, aux_c = _composite_fwd(sig, c0, c1, c2, z, cdelta, cmask,
                                  white_bg)
    return out_f, out_c, (aux_f, aux_c)


def composite_bwd_dual_in_kernel(c0, c1, c2, z, g8f, g8c, aux,
                                 white_bg: bool):
    """Backward of :func:`composite_fwd_dual_in_kernel` for the fine and
    coarse per-ray cotangents: ``(gsig, gc0, gc1, gc2)``, the sums of both
    composites' cotangents on the union planes (no dz: the dual mode is
    for training and code optimization, which never differentiate z)."""
    gf = _composite_grads(c0, c1, c2, z, g8f, aux[0], white_bg)
    gc = _composite_grads(c0, c1, c2, z, g8c, aux[1], white_bg)
    return tuple(a + b for a, b in zip(gf[:4], gc[:4]))
