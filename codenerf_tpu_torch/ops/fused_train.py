"""Single-pass CodeNeRF loss kernel for Hopper, in its two modes.

Replaces ``codenerf_tpu/ops/fused_train.py::_train_kernel`` (launched by
``invoke_train_fused``). Per ray: xyz = ro + vd·z and its 64-lane
positional encoding, the trunk (bf16 matmuls, f32 accumulation, per-ray
latent injection), softplus sigma and the rgb head, the volume-rendering
composite, the per-ray squared error, the cotangent 2·scale·(rgb − gt), the
composite backward, and the dx chain down to shape block 0, written as the
per-ray bf16 ray sums ``d_sproj``, ``d_tproj``, ``d_vcontrib``.

- ``weight_grads=False`` (with or without ``want_rgb``): the frozen-model
  mode of test-time code optimization.
- ``weight_grads=True``: category training. It also returns every weight's
  and bias's f32 gradient summed over all points, in :func:`weight_shapes`
  order: ``dW = x^T @ gh`` and ``db = Σ gh`` per layer (x the layer's bf16
  input, gh its bf16 output cotangent), ``Σ t·dsig`` and ``Σ dsig`` for
  the sigma head.

The other modes of the TPU kernel (``want_weights``, ``input_grads``, the
dual composite) raise ``NotImplementedError`` naming their ROADMAP.md item.

What bounds it on an H100. Matmul operations per point: forward
2W(64 + W(nb+nt+2) + W/2), the dx chain 2W(W(nb+nt+2) + W/2) and, with
weight gradients, the dW products as many as the forward. At W=256, nb=3,
nt=1 that is 884,736 + 851,968 (+ 884,736) FLOP per point: for a 4096-ray
× 96-sample call without weight gradients 6.8e11 FLOP, 0.69 ms at
989 TFLOP/s dense bf16; for a 16,384-ray × 96-sample training step
4.12e12 FLOP, 4.17 ms. The bytes the function must move (its inputs and
outputs, the weights and their f32 gradients) are ~25 MB and ~0.1 GB,
7.5 µs and ~0.03 ms at 3.35 TB/s, so both modes are bound by operations.

The design (``csrc/train_fused.cu``). The TPU kernel keeps all weights and
every activation of a 16-ray tile (~6 MB) resident in VMEM, and in
training its dW/db blocks stay resident as accumulators over the
sequential grid; an H100 block has 227 KB of shared memory and blocks run
in no order. This design is simple and right before it is fast: (i) a
tiled bf16 WMMA GEMM fed by a 3-stage ``cp.async`` pipeline, with
bias/ReLU epilogues that also write the next layer's latent-injected
input, each bf16 activation going to a device-memory workspace (~2.6 GB
per 4096 rays; ~0.25 GB per 4096 rays more in training, for the stored PE
and y0); (ii) a per-ray head kernel — sigma and rgb heads, the composite
as a warp scan over the samples, the loss and the composite backward, and
in training the per-ray sums of the sigma and rgb_out gradients; (iii)
the same GEMM transposed for the dx chain, with the ReLU masks, the sigma
term and the per-ray row sums fused into its epilogue; (iv) in training, a
dW GEMM per layer whose reduction axis is the points, split across
blocks into f32 partial tiles that a column-sum kernel then adds in a
fixed order — so dW and db are the same bits on every run, while the
per-ray code cotangents, summed with f32 atomics, may differ in their last
bits. The activations' round trips through HBM put a floor of ~2 ms per
4096 rays under this design; keeping activations on chip (and
``wgmma``/TMA) is later work.

Beside the kernel: :func:`train_fused_plain`, the same function in plain
PyTorch (the CPU tests and ``chip_smoke.py`` use it; the main path never
does on CUDA), the launch counters ``train_fused.launches["codes"]`` and
``["train"]`` (one per mode), and the ``autograd.Function`` s
:class:`FusedCodesLoss` (codes only) and :class:`FusedTrainLoss` (codes and
weights), which hand the kernel's cotangents to the prologue's backward.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.ops import fused_mlp

# The TPU kernel's ray tile. The CUDA kernel does not tile rays this way,
# but the port keeps the TPU's eligibility rule so both packages take the
# single-pass route on the same problems.
_TRAIN_TILE_RAYS = 16
_KERNEL = "train_fused"
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
    sigma row as a (W,) vector, enc_viewdir's trunk rows [:W].
    Differentiable, as ``flatten_params_f32`` is in the JAX package: the
    kernel's dW/db flow back through the transposes, pads and slices into
    the model's parameters (a frozen model simply has none that require
    gradients)."""
    W = cfg.W

    def wt(name):
        return getattr(model, name).weight.float().T

    def bias(name):
        return getattr(model, name).bias.float()

    def pad(x, rows=None, cols=None):
        r = (rows or x.shape[0]) - x.shape[0]
        c = (cols or x.shape[1]) - x.shape[1]
        return torch.nn.functional.pad(x, (0, c, 0, r))

    out = [pad(wt("enc_xyz"), rows=64), bias("enc_xyz")]
    for j in range(cfg.shape_blocks):
        out += [wt(f"shape_{j}"), bias(f"shape_{j}")]
    out += [wt("enc_shape"), bias("enc_shape")]
    out += [model.sigma.weight.float()[0], bias("sigma")]
    out += [model.enc_viewdir.weight.float()[:, :W].T,
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


def _check_mode(want_weights, input_grads, coarse_mask, coarse_delta):
    if want_weights:
        raise NotImplementedError(
            "train_fused(want_weights=True) — the weights plane for "
            "hierarchical sampling — is not ported yet (ROADMAP.md Queue 2, "
            "item 7)")
    if input_grads:
        raise NotImplementedError(
            "train_fused(input_grads=True) — pose optimization — is not "
            "ported yet (ROADMAP.md Queue 2, item 8)")
    if coarse_mask is not None or coarse_delta is not None:
        raise NotImplementedError(
            "train_fused dual-composite mode — hierarchical sampling — is "
            "not ported yet (ROADMAP.md Queue 2, item 5)")


def train_fused(cfg: NetConfig, S: int, R: int, white_bg: bool,
                scale: float, ro8, vd8, z, sproj, tproj, vcontrib, gt8,
                wflat, want_weights: bool = False, want_rgb: bool = False,
                weight_grads: bool = True, input_grads: bool = False,
                coarse_mask=None, coarse_delta=None):
    """Counterpart of ``invoke_train_fused``: returns ``(se_sum () f32,
    d_sproj (R, nb, W) bf16, d_tproj (R, nt, W) bf16, d_vcontrib (R, W)
    bf16[, rgb8 (R, 8) f32][, dW_0, db_0, dW_1, ...])``, the weight and
    bias gradients f32 in :func:`weight_shapes` order. Every cotangent is
    that of ``scale · se_sum`` (the kernel's cotangent is 2·scale·diff).

    On CPU tensors this is :func:`train_fused_plain`; on CUDA tensors it
    launches the CUDA kernel (and counts the launch in its mode's
    counter)."""
    _check_mode(want_weights, input_grads, coarse_mask, coarse_delta)
    if z.shape != (R, S):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {(R, S)}")
    if z.device.type == "cpu":
        return train_fused_plain(cfg, S, R, white_bg, scale, ro8, vd8, z,
                                 sproj, tproj, vcontrib, gt8, wflat,
                                 want_rgb=want_rgb, weight_grads=weight_grads)
    if z.device.type != "cuda":
        raise ValueError(f"train_fused: unsupported device {z.device}")
    outs = _launch_cuda(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                        tproj, vcontrib, gt8, wflat, want_rgb, weight_grads)
    train_fused.launches["train" if weight_grads else "codes"] += 1
    return outs


train_fused.launches = {"codes": 0, "train": 0}


def _softplus(x):
    # jax.nn.softplus = logaddexp(x, 0)
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def train_fused_plain(cfg: NetConfig, S: int, R: int, white_bg: bool,
                      scale: float, ro8, vd8, z, sproj, tproj, vcontrib,
                      gt8, wflat, want_rgb: bool = False,
                      weight_grads: bool = False, sigma_terms=None):
    """The kernel's function in plain PyTorch, rounding where the TPU
    kernel rounds: bf16 activations after each ReLU, the latent injection
    as a bf16 add, sig_pre in f32 from bf16 t, ReLU masks on the stored
    bf16 activations, the composite in f32; each output cotangent gh
    rounded to bf16 before both its dx and its dW product (exact bf16
    products, f32 sums), the sigma dW from bf16 t times f32 dsig.

    ``sigma_terms``, a list, receives ``(Σ|t·dsig| (W,), Σ|dsig| (1,))``:
    the size of the terms of the sigma head's gradient sums, which cancel
    heavily (comparisons scale their bar by it)."""
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

    dwb = {}

    def acc(name, x, gh):   # dW = x^T @ gh, db = Σ gh, f32
        if weight_grads:
            dwb[name] = (x.float().T @ gh.float(), gh.float().sum(0))

    # ---- forward
    xyz8 = (ro8[:, None, :] + vd8[:, None, :] * z[:, :, None]).reshape(P, 8)
    pe = fused_mlp.pe_in_kernel(xyz8, cfg.num_xyz_freq).to(bf16)
    y0 = torch.relu(dot(pe, w("enc_xyz")) + b("enc_xyz")).to(bf16)
    xs, ys, cur = [], [], y0
    for j in range(nb):
        xs.append(inject(cur, sproj[:, j]))
        cur = torch.relu(dot(xs[j], w(f"shape_{j}"))
                         + b(f"shape_{j}")).to(bf16)
        ys.append(cur)
    t = (dot(cur, w("enc_shape")) + b("enc_shape")).to(bf16)
    w_sig = w("sigma")
    sig_pre = (t.float() * w_sig[None, :]).sum(-1).view(R, S) + b("sigma")[0]
    u = dot(t, w("enc_viewdir_pt"))
    yv = torch.relu(u.view(R, S, W) + vcontrib[:, None, :].float()
                    ).view(P, W).to(bf16)
    xts, yts, cur = [], [], yv
    for j in range(nt):
        xts.append(inject(cur, tproj[:, j]))
        cur = torch.relu(dot(xts[j], w(f"texture_{j}"))
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

    # ---- dx chain (and dW/db)
    gh8 = torch.zeros(R, S, 8, dtype=f32, device=z.device)
    gh8[..., 0], gh8[..., 1], gh8[..., 2] = gc0, gc1, gc2
    gh8 = gh8.view(P, 8).to(bf16)
    acc("rgb_out", r, gh8)
    gr = dot_t(gh8, w("rgb_out"))
    gh = (gr * (r.float() > 0)).to(bf16)
    acc("rgb_hidden", yts[-1], gh)
    g_cur = dot_t(gh, w("rgb_hidden"))
    d_tproj = torch.empty(R, nt, W, dtype=bf16, device=z.device)
    for j in reversed(range(nt)):
        gh = (g_cur * (yts[j].float() > 0)).to(bf16)
        acc(f"texture_{j}", xts[j], gh)
        g_cur = dot_t(gh, w(f"texture_{j}"))
        d_tproj[:, j] = ray_sum(g_cur).to(bf16)
    gu = g_cur * (yv.float() > 0)
    d_vcontrib = ray_sum(gu).to(bf16)
    gu16 = gu.to(bf16)
    acc("enc_viewdir_pt", t, gu16)
    g_t = dot_t(gu16, w("enc_viewdir_pt"))
    dsig = g_sigma * torch.sigmoid(sig_pre)
    g_t = (g_t.view(R, S, W) + dsig[:, :, None] * w_sig[None, None, :]
           ).view(P, W)
    if weight_grads:
        t_dsig = t.float().view(R, S, W) * dsig[:, :, None]
        dwb["sigma"] = (t_dsig.sum((0, 1)), dsig.sum().reshape(1))
        if sigma_terms is not None:
            sigma_terms += [t_dsig.abs().sum((0, 1)),
                            dsig.abs().sum().reshape(1)]
    gh = g_t.to(bf16)
    acc("enc_shape", ys[-1], gh)
    g_cur = dot_t(gh, w("enc_shape"))
    d_sproj = torch.empty(R, nb, W, dtype=bf16, device=z.device)
    for j in reversed(range(nb)):
        gh = (g_cur * (ys[j].float() > 0)).to(bf16)
        acc(f"shape_{j}", xs[j], gh)
        g_cur = dot_t(gh, w(f"shape_{j}"))
        d_sproj[:, j] = ray_sum(g_cur).to(bf16)
    if weight_grads:
        acc("enc_xyz", pe, (g_cur * (y0.float() > 0)).to(bf16))

    outs = (se8.sum(), d_sproj, d_tproj, d_vcontrib)
    if want_rgb:
        outs += (out8,)
    for name, _, _ in (weight_shapes(cfg) if weight_grads else ()):
        outs += dwb[name]
    return outs


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _ptr_array(xs) -> ctypes.c_void_p:
    arr = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _aligned(x: torch.Tensor, dtype) -> torch.Tensor:
    """Contiguous, of ``dtype``, 16-byte aligned (the kernel loads 16 B)."""
    x = x.to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bind(lib: ctypes.CDLL):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_step.argtypes = ([vp] * 16 + [ci] * 7
                               + [ctypes.c_float, ci, vp])
    lib.fused_step.restype = ci
    lib.fused_workspace.argtypes = [ci] * 6 + [vp, vp]
    lib.fused_workspace.restype = None


def _launch_cuda(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj, tproj,
                 vcontrib, gt8, wflat, want_rgb, weight_grads):
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
    lib.fused_workspace(R, S, W, nb, nt, int(weight_grads),
                        ctypes.addressof(n_bf16), ctypes.addressof(n_f32))
    ws = torch.empty(n_bf16.value, dtype=bf16, device=dev)
    ws32 = torch.empty(n_f32.value, dtype=f32, device=dev)
    se8 = torch.empty(R, 8, dtype=f32, device=dev)
    rgb8 = torch.empty(R, 8, dtype=f32, device=dev) if want_rgb else None
    d_sproj = torch.empty(R, nb, W, dtype=bf16, device=dev)
    d_tproj = torch.empty(R, nt, W, dtype=bf16, device=dev)
    d_vcontrib = torch.empty(R, W, dtype=bf16, device=dev)
    dwb = []
    if weight_grads:
        for _, ws_, bs_ in weight_shapes(cfg):
            dwb += [torch.empty(ws_, dtype=f32, device=dev),
                    torch.empty(bs_, dtype=f32, device=dev)]
    wptrs, _keep_w = _ptr_array(wops)
    dptrs, _keep_d = (_ptr_array(dwb) if weight_grads
                      else (ctypes.c_void_p(0), None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_step(
        _ptr(ins["ro8"]), _ptr(ins["vd8"]), _ptr(ins["z"]),
        _ptr(ins["sproj"]), _ptr(ins["tproj"]), _ptr(ins["vcontrib"]),
        _ptr(ins["gt8"]), wptrs, _ptr(ws), _ptr(ws32), _ptr(se8),
        ctypes.c_void_p(rgb8.data_ptr() if want_rgb else 0),
        _ptr(d_sproj), _ptr(d_tproj), _ptr(d_vcontrib), dptrs,
        int(bool(weight_grads)), R, S, W, nb, nt, cfg.num_xyz_freq,
        ctypes.c_float(2.0 * scale), int(bool(white_bg)),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"train_fused CUDA kernel failed: cudaError {rc}")
    outs = (se8.sum(), d_sproj, d_tproj, d_vcontrib)
    if want_rgb:
        outs += (rgb8,)
    return outs + tuple(dwb)


class FusedCodesLoss(torch.autograd.Function):
    """``scale · Σ squared error`` of one chunk under a frozen model,
    differentiable with respect to the per-ray operands ``(sproj, tproj,
    vcontrib)``: the kernel (``weight_grads=False``) computes the loss and
    its cotangents in one pass, and the backward hands those cotangents on
    (times the incoming gradient). Also returns the composited ``rgb8``
    rows (empty unless ``want_rgb``), which carry no gradient."""

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


class FusedTrainLoss(torch.autograd.Function):
    """``scale · Σ squared error`` of one batch, differentiable with
    respect to the per-ray operands and every weight operand:
    ``apply(static, sproj, tproj, vcontrib, *wflat)`` with ``static =
    (cfg, white_bg, scale, ro8, vd8, z, gt8)`` and ``wflat`` the f32
    operands of :func:`flatten_params`. The kernel (``weight_grads=True``)
    computes the loss, the per-ray cotangents and every dW/db in one pass;
    the backward hands them on times the incoming gradient, and autograd
    chains them through the prologue into the model and the codes."""

    @staticmethod
    def forward(ctx, static, sproj, tproj, vcontrib, *wflat):
        cfg, white_bg, scale, ro8, vd8, z, gt8 = static
        R, S = z.shape
        outs = train_fused(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                           tproj, vcontrib, gt8, list(wflat),
                           weight_grads=True)
        ctx.save_for_backward(*outs[1:])
        return outs[0] * scale

    @staticmethod
    def backward(ctx, g_loss):
        return (None,) + tuple(x * g_loss for x in ctx.saved_tensors)
