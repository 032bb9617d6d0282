"""Single-pass CodeNeRF loss kernel, frozen-model mode, for Hopper.

Replaces ``codenerf_tpu/ops/fused_train.py::_train_kernel`` (launched by
``invoke_train_fused``) in the mode ``weight_grads=False`` with or without
``want_rgb`` — the test-time code optimization step. Per ray: xyz = ro +
vd·z and its 64-lane positional encoding, the trunk (bf16 matmuls, f32
accumulation, per-ray latent injection), softplus sigma and the rgb head,
the volume-rendering composite, the per-ray squared error, the cotangent
2·scale·(rgb − gt), the composite backward, and the dx chain down to shape
block 0, written as the per-ray bf16 ray sums ``d_sproj``, ``d_tproj``,
``d_vcontrib``. No weight gradients. The other modes of the TPU kernel
(``weight_grads=True``, ``want_weights``, ``input_grads``, the dual
composite) raise ``NotImplementedError`` naming their ROADMAP.md item.

What bounds it on an H100. Matmul operations: forward
2·P·(64W + W²(nb+nt+2) + W²/2) plus the dx chain 2·P·(W²(nb+nt+2) + W²/2)
for P = rays·samples points — 6.8e11 FLOP for a 4096-ray × 96-sample chunk
at W=256, nb=3, nt=1, i.e. 0.69 ms at 989 TFLOP/s dense bf16. The bytes the
function must move (its inputs and outputs) are ~25 MB, 7.5 µs at
3.35 TB/s, so the function is bound by operations.

The design (``csrc/train_fused_codes.cu``). The TPU kernel keeps all
weights and every activation of a 16-ray tile (~6 MB) resident in VMEM; an
H100 block has 227 KB of shared memory. This design is simple and right
before it is fast: (i) a tiled bf16 WMMA GEMM fed by a 3-stage
``cp.async`` pipeline, with the PE built in its A-tile load for enc_xyz and
bias/ReLU epilogues that also write the next layer's latent-injected
input, each bf16 activation going to a device-memory workspace (~2.6 GB
per 4096-ray chunk); (ii) a per-ray head kernel — sigma and rgb heads, the
composite as a warp scan over the samples, the loss and the composite
backward; (iii) the same GEMM transposed for the dx chain, with the ReLU
masks, the sigma term and the per-ray row sums fused into its epilogue.
The activations' round trips through HBM put a floor of ~2 ms per chunk
under this design, ~3× its operations bound; keeping activations on chip
(and ``wgmma``/TMA) is later work.

Beside the kernel: :func:`train_fused_plain`, the same function in plain
PyTorch (the CPU tests and ``chip_smoke.py`` use it; the main path never
does on CUDA), the launch counter ``train_fused.launches``, and
:class:`FusedCodesLoss`, the ``autograd.Function`` that hands the kernel's
cotangents to the prologue's backward.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.ops import fused_mlp

# The TPU kernel's ray tile. The CUDA kernel does not tile rays this way,
# but the optimization path keeps the TPU's eligibility rule so both
# packages take the single-pass route on the same problems.
_TRAIN_TILE_RAYS = 16
_KERNEL = "train_fused_codes"
_MAX_SAMPLES = 256   # the head kernel's scan holds 8 samples per lane


def single_pass_available(cfg: NetConfig, n_rays: int) -> bool:
    return (cfg.W % 256 == 0 and cfg.d_xyz <= 64 and cfg.shape_blocks >= 1
            and cfg.texture_blocks >= 1 and n_rays % _TRAIN_TILE_RAYS == 0)


def weight_shapes(cfg: NetConfig) -> List[Tuple[str, tuple, tuple]]:
    """(name, w_shape, b_shape) in operand order. enc_viewdir's bias rides
    in vcontrib, so its slot is a zero vector."""
    W = cfg.W
    shapes = [("enc_xyz", (64, W), (W,))]
    shapes += [(f"shape_{j}", (W, W), (W,)) for j in range(cfg.shape_blocks)]
    shapes += [("enc_shape", (W, W), (W,)), ("sigma", (W,), (1,)),
               ("enc_viewdir_pt", (W, W), (W,))]
    shapes += [(f"texture_{j}", (W, W), (W,))
               for j in range(cfg.texture_blocks)]
    shapes += [("rgb_hidden", (W, W // 2), (W // 2,)),
               ("rgb_out", (W // 2, 8), (8,))]
    return shapes


def flatten_params(model, cfg: NetConfig) -> List[torch.Tensor]:
    """The kernel's f32 weight operands from a ``CodeNeRF``: 2-D weights
    (in, out), enc_xyz padded to 64 rows, rgb_out padded to 8 columns, the
    sigma row as a (W,) vector, enc_viewdir's trunk rows [:W]. Detached:
    the model is frozen on this path."""
    W = cfg.W

    def wt(name):
        return getattr(model, name).weight.detach().float().T

    def bias(name):
        return getattr(model, name).bias.detach().float()

    def pad(x, rows=None, cols=None):
        r = (rows or x.shape[0]) - x.shape[0]
        c = (cols or x.shape[1]) - x.shape[1]
        return torch.nn.functional.pad(x, (0, c, 0, r))

    out = [pad(wt("enc_xyz"), rows=64), bias("enc_xyz")]
    for j in range(cfg.shape_blocks):
        out += [wt(f"shape_{j}"), bias(f"shape_{j}")]
    out += [wt("enc_shape"), bias("enc_shape")]
    out += [model.sigma.weight.detach().float()[0], bias("sigma")]
    out += [model.enc_viewdir.weight.detach().float()[:, :W].T,
            torch.zeros(W, device=model.enc_viewdir.weight.device)]
    for j in range(cfg.texture_blocks):
        out += [wt(f"texture_{j}"), bias(f"texture_{j}")]
    out += [wt("rgb_hidden"), bias("rgb_hidden")]
    out += [pad(wt("rgb_out"), cols=8),
            torch.nn.functional.pad(bias("rgb_out"), (0, 5))]
    return [x.contiguous() for x in out]


def kernel_operands(wflat) -> List[torch.Tensor]:
    """2-D weights bf16, 1-D weights and biases f32, all contiguous — the
    dtypes the TPU kernel received (``wops`` in ``invoke_train_fused``)."""
    return [(w.to(torch.bfloat16) if w.dim() == 2 else w.float()).contiguous()
            for w in wflat]


def _check_mode(want_weights, weight_grads, input_grads, coarse_mask,
                coarse_delta):
    if weight_grads:
        raise NotImplementedError(
            "train_fused(weight_grads=True) — the training kernel — is not "
            "ported yet (ROADMAP.md Queue 2, item 1)")
    if want_weights:
        raise NotImplementedError(
            "train_fused(want_weights=True) — the weights plane for "
            "hierarchical sampling — is not ported yet (ROADMAP.md Queue 2)")
    if input_grads:
        raise NotImplementedError(
            "train_fused(input_grads=True) — pose optimization — is not "
            "ported yet (ROADMAP.md Queue 2)")
    if coarse_mask is not None or coarse_delta is not None:
        raise NotImplementedError(
            "train_fused dual-composite mode — hierarchical sampling — is "
            "not ported yet (ROADMAP.md Queue 2)")


def train_fused(cfg: NetConfig, S: int, R: int, white_bg: bool,
                scale: float, ro8, vd8, z, sproj, tproj, vcontrib, gt8,
                wflat, want_weights: bool = False, want_rgb: bool = False,
                weight_grads: bool = True, input_grads: bool = False,
                coarse_mask=None, coarse_delta=None):
    """Counterpart of ``invoke_train_fused``: returns ``(se_sum () f32,
    d_sproj (R, nb, W) bf16, d_tproj (R, nt, W) bf16, d_vcontrib (R, W)
    bf16[, rgb8 (R, 8) f32])``. The cotangents are those of
    ``scale · se_sum``. Only ``weight_grads=False`` runs.

    On CPU tensors this is :func:`train_fused_plain`; on CUDA tensors it
    launches the CUDA kernel (and counts the launch)."""
    _check_mode(want_weights, weight_grads, input_grads, coarse_mask,
                coarse_delta)
    if z.shape != (R, S):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {(R, S)}")
    if z.device.type == "cpu":
        return train_fused_plain(cfg, S, R, white_bg, scale, ro8, vd8, z,
                                 sproj, tproj, vcontrib, gt8, wflat,
                                 want_rgb=want_rgb)
    if z.device.type != "cuda":
        raise ValueError(f"train_fused: unsupported device {z.device}")
    outs = _launch_cuda(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                        tproj, vcontrib, gt8, wflat, want_rgb)
    train_fused.launches += 1
    return outs


train_fused.launches = 0


def _softplus(x):
    # jax.nn.softplus = logaddexp(x, 0)
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def train_fused_plain(cfg: NetConfig, S: int, R: int, white_bg: bool,
                      scale: float, ro8, vd8, z, sproj, tproj, vcontrib,
                      gt8, wflat, want_rgb: bool = False):
    """The kernel's function in plain PyTorch, rounding where the TPU
    kernel rounds: bf16 activations after each ReLU, the latent injection
    as a bf16 add, sig_pre in f32 from bf16 t, ReLU masks on the stored
    bf16 activations, the composite in f32."""
    f32, bf16 = torch.float32, torch.bfloat16
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    P = R * S
    wops = kernel_operands(wflat)
    idx = {n: j for j, (n, _, _) in enumerate(weight_shapes(cfg))}

    def w(name):
        return wops[2 * idx[name]]

    def b(name):
        return wops[2 * idx[name] + 1]

    def dot(x, wm):      # (P, A) bf16 @ (A, B) bf16 -> f32
        return x.float() @ wm.float()

    def dot_t(g, wm):    # (P, B) bf16 @ (A, B)^T -> (P, A) f32
        return g.float() @ wm.float().T

    def inject(y, proj):
        return (y.view(R, S, -1).float() + proj[:, None, :].float()
                ).to(bf16).view(P, -1)

    def ray_sum(x):
        return x.view(R, S, -1).sum(dim=1)

    # ---- forward
    xyz8 = (ro8[:, None, :] + vd8[:, None, :] * z[:, :, None]).reshape(P, 8)
    pe = fused_mlp.pe_in_kernel(xyz8, cfg.num_xyz_freq).to(bf16)
    y0 = torch.relu(dot(pe, w("enc_xyz")) + b("enc_xyz")).to(bf16)
    ys, cur = [], y0
    for j in range(nb):
        cur = torch.relu(dot(inject(cur, sproj[:, j]), w(f"shape_{j}"))
                         + b(f"shape_{j}")).to(bf16)
        ys.append(cur)
    t = (dot(cur, w("enc_shape")) + b("enc_shape")).to(bf16)
    w_sig = w("sigma")
    sig_pre = (t.float() * w_sig[None, :]).sum(-1).view(R, S) + b("sigma")[0]
    u = dot(t, w("enc_viewdir_pt"))
    yv = torch.relu(u.view(R, S, W) + vcontrib[:, None, :].float()
                    ).view(P, W).to(bf16)
    yts, cur = [], yv
    for j in range(nt):
        cur = torch.relu(dot(inject(cur, tproj[:, j]), w(f"texture_{j}"))
                         + b(f"texture_{j}")).to(bf16)
        yts.append(cur)
    r = torch.relu(dot(cur, w("rgb_hidden")) + b("rgb_hidden")).to(bf16)
    rgb = (dot(r, w("rgb_out")) + b("rgb_out")).view(R, S, 8)
    sigma = _softplus(sig_pre)
    c0, c1, c2 = rgb[..., 0], rgb[..., 1], rgb[..., 2]

    # ---- composite, loss, composite backward
    out8, aux = fused_mlp.composite_fwd_in_kernel(sigma, c0, c1, c2, z,
                                                  white_bg)
    lane8 = torch.arange(8, device=z.device)[None, :]
    diff = torch.where(lane8 < 3, out8 - gt8, torch.zeros_like(out8))
    se8 = diff * diff
    g8 = (2.0 * scale) * diff
    g_sigma, gc0, gc1, gc2, _ = fused_mlp.composite_bwd_in_kernel(
        sigma, c0, c1, c2, z, g8, aux, white_bg)

    # ---- dx chain
    gh8 = torch.zeros(R, S, 8, dtype=f32, device=z.device)
    gh8[..., 0], gh8[..., 1], gh8[..., 2] = gc0, gc1, gc2
    gh8 = gh8.view(P, 8).to(bf16)
    gr = dot_t(gh8, w("rgb_out"))
    gh = (gr * (r.float() > 0)).to(bf16)
    g_cur = dot_t(gh, w("rgb_hidden"))
    d_tproj = torch.empty(R, nt, W, dtype=bf16, device=z.device)
    for j in reversed(range(nt)):
        gh = (g_cur * (yts[j].float() > 0)).to(bf16)
        g_cur = dot_t(gh, w(f"texture_{j}"))
        d_tproj[:, j] = ray_sum(g_cur).to(bf16)
    gu = g_cur * (yv.float() > 0)
    d_vcontrib = ray_sum(gu).to(bf16)
    g_t = dot_t(gu.to(bf16), w("enc_viewdir_pt"))
    dsig = g_sigma * torch.sigmoid(sig_pre)
    g_t = (g_t.view(R, S, W) + dsig[:, :, None] * w_sig[None, None, :]
           ).view(P, W)
    g_cur = dot_t(g_t.to(bf16), w("enc_shape"))
    d_sproj = torch.empty(R, nb, W, dtype=bf16, device=z.device)
    for j in reversed(range(nb)):
        gh = (g_cur * (ys[j].float() > 0)).to(bf16)
        g_cur = dot_t(gh, w(f"shape_{j}"))
        d_sproj[:, j] = ray_sum(g_cur).to(bf16)

    outs = (se8.sum(), d_sproj, d_tproj, d_vcontrib)
    return outs + (out8,) if want_rgb else outs


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _aligned(x: torch.Tensor, dtype) -> torch.Tensor:
    """Contiguous, of ``dtype``, 16-byte aligned (the kernel loads 16 B)."""
    x = x.to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bind(lib: ctypes.CDLL):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.codes_step.argtypes = [vp] * 15 + [ci] * 6 + [ctypes.c_float, ci, vp]
    lib.codes_step.restype = ci
    lib.codes_workspace.argtypes = [ci] * 5 + [vp, vp]
    lib.codes_workspace.restype = None


def _launch_cuda(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj, tproj,
                 vcontrib, gt8, wflat, want_rgb):
    from codenerf_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    if not getattr(lib, "_bound", False):
        _bind(lib)
        lib._bound = True
    dev = z.device
    f32, bf16 = torch.float32, torch.bfloat16
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    if S > _MAX_SAMPLES or not single_pass_available(cfg, R):
        raise ValueError(f"train_fused: the CUDA kernel takes S <= "
                         f"{_MAX_SAMPLES}, W % 256 == 0, d_xyz <= 64 and "
                         f"R % 16 == 0; got S={S}, W={W}, R={R}")
    ins = dict(ro8=_aligned(ro8, f32), vd8=_aligned(vd8, f32),
               z=_aligned(z, f32), sproj=_aligned(sproj, bf16),
               tproj=_aligned(tproj, bf16), vcontrib=_aligned(vcontrib, bf16),
               gt8=_aligned(gt8, f32))
    expect = dict(ro8=(R, 8), vd8=(R, 8), z=(R, S), sproj=(R, nb, W),
                  tproj=(R, nt, W), vcontrib=(R, W), gt8=(R, 8))
    for name, x in ins.items():
        if tuple(x.shape) != expect[name] or x.device != dev:
            raise ValueError(f"train_fused: {name} is {tuple(x.shape)} on "
                             f"{x.device}, expected {expect[name]} on {dev}")
    wops = [_aligned(w, w.dtype) for w in kernel_operands(wflat)]
    for w_, (name, ws, bs) in zip(wops[0::2], weight_shapes(cfg)):
        if tuple(w_.shape) != ws or w_.device != dev:
            raise ValueError(f"train_fused: weight {name} is "
                             f"{tuple(w_.shape)}, expected {ws}")
    n_bf16, n_f32 = ctypes.c_size_t(), ctypes.c_size_t()
    lib.codes_workspace(R, S, W, nb, nt, ctypes.addressof(n_bf16),
                        ctypes.addressof(n_f32))
    ws = torch.empty(n_bf16.value, dtype=bf16, device=dev)
    ws32 = torch.empty(n_f32.value, dtype=f32, device=dev)
    se8 = torch.empty(R, 8, dtype=f32, device=dev)
    rgb8 = torch.empty(R, 8, dtype=f32, device=dev) if want_rgb else None
    d_sproj = torch.empty(R, nb, W, dtype=bf16, device=dev)
    d_tproj = torch.empty(R, nt, W, dtype=bf16, device=dev)
    d_vcontrib = torch.empty(R, W, dtype=bf16, device=dev)
    wptrs = (ctypes.c_void_p * len(wops))(*[w.data_ptr() for w in wops])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.codes_step(
        _ptr(ins["ro8"]), _ptr(ins["vd8"]), _ptr(ins["z"]),
        _ptr(ins["sproj"]), _ptr(ins["tproj"]), _ptr(ins["vcontrib"]),
        _ptr(ins["gt8"]), ctypes.cast(wptrs, ctypes.c_void_p), _ptr(ws),
        _ptr(ws32), _ptr(se8),
        ctypes.c_void_p(rgb8.data_ptr() if want_rgb else 0),
        _ptr(d_sproj), _ptr(d_tproj), _ptr(d_vcontrib),
        R, S, W, nb, nt, cfg.num_xyz_freq, ctypes.c_float(2.0 * scale),
        int(bool(white_bg)), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"train_fused CUDA kernel failed: cudaError {rc}")
    outs = (se8.sum(), d_sproj, d_tproj, d_vcontrib)
    return outs + (rgb8,) if want_rgb else outs


class FusedCodesLoss(torch.autograd.Function):
    """``scale · Σ squared error`` of one chunk, differentiable with
    respect to the per-ray operands ``(sproj, tproj, vcontrib)``: the
    kernel computes the loss and its cotangents in one pass, and the
    backward hands those cotangents on (times the incoming gradient).
    Also returns the composited ``rgb8`` rows (empty unless ``want_rgb``),
    which carry no gradient."""

    @staticmethod
    def forward(ctx, sproj, tproj, vcontrib, cfg, white_bg, scale, ro8,
                vd8, z, gt8, wops, want_rgb):
        R, S = z.shape
        outs = train_fused(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                           tproj, vcontrib, gt8, wops, want_rgb=want_rgb,
                           weight_grads=False)
        se, d_sproj, d_tproj, d_vcontrib = outs[:4]
        rgb8 = outs[4] if want_rgb else z.new_empty(0, 8)
        ctx.save_for_backward(d_sproj, d_tproj, d_vcontrib)
        ctx.mark_non_differentiable(rgb8)
        return se * scale, rgb8

    @staticmethod
    def backward(ctx, g_loss, g_rgb8):
        d_sproj, d_tproj, d_vcontrib = ctx.saved_tensors
        return ((d_sproj * g_loss, d_tproj * g_loss, d_vcontrib * g_loss)
                + (None,) * 9)
