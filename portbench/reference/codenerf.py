"""Plain CodeNeRF: positional encoding, the MLP with code injection, rays,
stratified depths and the volume-rendering composite, in float32.

Layer names follow the port's checkpoints (``enc_xyz``, ``shape_latent_j``,
``shape_j``, ``enc_shape``, ``sigma``, ``enc_viewdir``, ``texture_latent_j``,
``texture_j``, ``rgb_hidden``, ``rgb_out``), each a weight (out, in) and a
bias (out,), so one parameter dict drives both sides. The equations are
the published model's (``src/model.py:10-53``): ReLU blocks, the code's
projection added before each block, softplus density from the linear
``enc_shape`` output, no output sigmoid on the colour.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Params = Dict[str, torch.Tensor]

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
F8_GRAD = torch.float8_e5m2
F8_GRAD_MAX = 57344.0


def layer_shapes(net: dict) -> List[Tuple[str, int, int]]:
    """``(name, fan_in, fan_out)`` of every linear layer, in the order the
    weights are drawn. ``net`` holds the ``net_hyperparams`` keys."""
    W, D = net["W"], net["latent_dim"]
    d_xyz = 3 + 6 * net["num_xyz_freq"]
    d_dir = 3 + 6 * net["num_dir_freq"]
    out = [("enc_xyz", d_xyz, W)]
    for j in range(net["shape_blocks"]):
        out += [(f"shape_latent_{j}", D, W), (f"shape_{j}", W, W)]
    out += [("enc_shape", W, W), ("sigma", W, 1),
            ("enc_viewdir", W + d_dir, W)]
    for j in range(net["texture_blocks"]):
        out += [(f"texture_latent_{j}", D, W), (f"texture_{j}", W, W)]
    return out + [("rgb_hidden", W, W // 2), ("rgb_out", W // 2, 3)]


def fp8_round(x: torch.Tensor, dtype=F8, top: float = F8_MAX
              ) -> torch.Tensor:
    """``x`` through an fp8 type with one scale for the tensor (its
    largest magnitude onto the type's largest), back in float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).float() / scale


class Fp8Product(torch.autograd.Function):
    """``x @ w.T`` as fp8 training computes it: e4m3 operands forward,
    e5m2 output cotangents backward, each with its own scale, products
    summed in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        return torch.matmul(xq, wq.T)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g, F8_GRAD, F8_GRAD_MAX)
        dx = torch.matmul(gq, wq)
        dw = torch.matmul(gq.reshape(-1, gq.shape[-1]).T,
                          xq.reshape(-1, xq.shape[-1]))
        return dx, dw


class Precision:
    """How the reference multiplies: ``"f32"`` (float32, TF32 off) or
    ``"fp8"`` (:class:`Fp8Product`): the control one precision below the
    configuration's bfloat16."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w.T`` for a (out, in) weight."""
        if self.name == "fp8":
            return Fp8Product.apply(x, w)
        return torch.matmul(x, w.T)


def set_exact_float32() -> None:
    """Float32 products stay float32 on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``[x, sin(2^k x), cos(2^k x)]``, frequency-major within each of
    sin and cos (the port's channel order)."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device)
    scaled = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1],
                                                       3 * n_freqs)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)


def forward(p: Params, net: dict, xyz: torch.Tensor, viewdir: torch.Tensor,
            shape_code: torch.Tensor, texture_code: torch.Tensor,
            prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density (R, S) and raw colour (R, S, 3) of points ``xyz`` (R, S, 3)
    seen along ``viewdir`` (R, 3); codes (R, D)."""
    def lin(name, x):
        return prec.mm(x, p[f"{name}.weight"]) + p[f"{name}.bias"]

    R, S = xyz.shape[:2]
    y = torch.relu(lin("enc_xyz", positional_encoding(xyz,
                                                      net["num_xyz_freq"])))
    for j in range(net["shape_blocks"]):
        z = torch.relu(lin(f"shape_latent_{j}", shape_code))
        y = torch.relu(lin(f"shape_{j}", y + z[:, None, :]))
    y = lin("enc_shape", y)
    sigma = torch.nn.functional.softplus(lin("sigma", y))[..., 0]
    vd = positional_encoding(viewdir, net["num_dir_freq"])
    y = torch.relu(lin("enc_viewdir", torch.cat(
        [y, vd[:, None, :].expand(R, S, vd.shape[-1])], dim=-1)))
    for j in range(net["texture_blocks"]):
        z = torch.relu(lin(f"texture_latent_{j}", texture_code))
        y = torch.relu(lin(f"texture_{j}", y + z[:, None, :]))
    y = torch.relu(lin("rgb_hidden", y))
    return sigma, lin("rgb_out", y)


def pixel_rays(uv: torch.Tensor, focal: torch.Tensor, c2w: torch.Tensor,
               H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins and unit directions of pixels ``uv`` (u = column, v = row)
    of pinhole cameras ``c2w`` (..., 4, 4), OpenGL axes (``src/utils.py:
    10-19``)."""
    u, v = uv[..., 0].float(), uv[..., 1].float()
    dirs = torch.stack([(u - W * 0.5) / focal, -(v - H * 0.5) / focal,
                        -torch.ones_like(u)], dim=-1)
    d = (c2w[..., :3, :3] * dirs[..., None, :]).sum(-1)
    return c2w[..., :3, 3], d / torch.linalg.norm(d, dim=-1, keepdim=True)


def stratified_z(near: float, far: float,
                 jitter: torch.Tensor) -> torch.Tensor:
    """Midpoints of ``S`` equal cells of ``[near, far]`` moved by
    ``jitter`` (R, S) in [0, 1) half-cells (``src/utils.py:21-32``)."""
    S = jitter.shape[-1]
    half = (far - near) / (2.0 * S)
    base = torch.linspace(near + half, far - half, S, dtype=torch.float32,
                          device=jitter.device)
    return base + jitter * half


def composite(sigma: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor,
              white_bg: bool = True):
    """``(rgb (R, 3), weights (R, S))``: alpha compositing with a 1e10
    last interval and the 1e-10 transmittance floor, white background
    filled in (``src/utils.py:34-47``)."""
    delta = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], dim=-1), dim=-1)
    w = alpha * trans[:, :-1]
    out = (w[..., None] * rgb).sum(1)
    if white_bg:
        out = out + (1.0 - w.sum(-1))[:, None]
    return out, w
