"""Operations, bytes and bounds of the port's kernels and steps, and the
H100's peaks: the benchmark's yardstick.

A frozen copy of ``chip_smoke.py``'s ``_bound``, ``bound``,
``sigma_bound``, ``trunk_rates`` and ``head_dw_rates`` arithmetic, written
against the network's widths alone (no weight tensors: the weights'
bytes are counted from their shapes, bf16 as the kernels read them).
A bound is the larger of the matmul operations at the dense bf16 peak and
the bytes the call must move (each input read once, each output written
once) at the HBM rate, in milliseconds.
"""

from __future__ import annotations

from typing import Tuple

from portbench.reference.codenerf import layer_shapes

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3


def bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3


def widths(net: dict) -> Tuple[int, int, int]:
    return net["W"], net["shape_blocks"], net["texture_blocks"]


def trunk_flops_per_point(net: dict) -> int:
    """The forward's matmuls at one point: the 64-lane PE into W, the
    shape and texture blocks, enc_shape and enc_viewdir's trunk rows
    (W x W each), rgb_hidden (W x W/2)."""
    W, nb, nt = widths(net)
    return 2 * (64 * W + W * W * (nb + nt + 2) + W * W // 2)


def dx_flops_per_point(net: dict) -> int:
    """The input cotangents' matmuls at one point (none into the PE)."""
    W, nb, nt = widths(net)
    return 2 * (W * W * (nb + nt + 2) + W * W // 2)


def sigma_flops_per_point(net: dict) -> int:
    """The sigma-only trunk: the PE, the shape blocks and enc_shape."""
    W, nb, _ = widths(net)
    return 2 * W * (64 + W * (nb + 1))


def weight_bytes(net: dict) -> int:
    """The networks' weights and biases as the kernels read them (bf16)."""
    return 2 * sum(o * (i + 1) for _, i, o in layer_shapes(net))


def weight_count(net: dict) -> int:
    return sum(o * (i + 1) for _, i, o in layer_shapes(net))


def single_pass_bound(net: dict, R: int, S: int, weight_grads: bool,
                      dual: bool = False) -> float:
    """The single-pass loss kernel's bound (``chip_smoke.bound``): the
    forward, the input cotangents and, with ``weight_grads``, the weight
    gradients' matmuls; the rays, depths, latents and weights read, the
    per-ray rows written and, with ``weight_grads``, every dW/db in f32;
    the dual mode reads the coarse mask and deltas besides, the frozen
    mode writes the rgb rows."""
    W, nb, nt = widths(net)
    P = R * S
    fwd = trunk_flops_per_point(net) * P
    flops = 2 * fwd + dx_flops_per_point(net) * P if weight_grads \
        else fwd + dx_flops_per_point(net) * P
    in_b = R * 8 * 4 * 3 + P * 4 + R * (nb + nt + 1) * W * 2 + \
        weight_bytes(net)
    if dual:
        in_b += 2 * P * 4
    out_b = R * 8 * 4 + R * (nb + nt + 1) * W * 2
    if weight_grads:
        out_b += 4 * weight_count(net)
    else:
        out_b += R * 8 * 4
    return bound_ms(flops, in_b + out_b)


def sigma_bound(net: dict, R: int, S: int) -> float:
    """The sigma-only forward (``chip_smoke.sigma_bound``): it reads the
    rays, depths, shape latents and the trunk's weights and writes sigma."""
    W, nb, _ = widths(net)
    trunk = [s for s in layer_shapes(net)
             if s[0] == "enc_xyz" or s[0].startswith("shape")
             or s[0] in ("enc_shape", "sigma")]
    w_b = 2 * sum(o * (i + 1) for _, i, o in trunk)
    nbytes = R * 8 * 4 * 2 + R * S * 4 + R * nb * W * 2 + w_b + R * S * 4
    return bound_ms(sigma_flops_per_point(net) * R * S, nbytes)


def trunk_fwd_bound(net: dict, points: int, weight_grads: bool) -> float:
    """``trunk_fwd_kernel`` over ``points`` points (``chip_smoke.
    trunk_rates``): it writes t, r and the ReLU-mask bit planes (32 B
    each) and, in training, every dW input (the PE, the injected inputs,
    the last shape and texture outputs) and enc_xyz's mask."""
    W, nb, nt = widths(net)
    per = 4 + 2 * W + W + (nb + nt + 1 + weight_grads) * 32
    if weight_grads:
        per += 2 * 64 + 2 * W * (nb + nt + 2)
    return bound_ms(trunk_flops_per_point(net) * points, per * points)


def trunk_dx_bound(net: dict, points: int, weight_grads: bool) -> float:
    """``trunk_dx_kernel``: it reads the rgb_hidden cotangent, dsig and
    the masks and, in training, writes every gh plane."""
    W, nb, nt = widths(net)
    per = W + 4 + (nb + nt + 1 + weight_grads) * 32
    if weight_grads:
        per += 2 * W * (nb + nt + 3)
    return bound_ms(dx_flops_per_point(net) * points, per * points)


def wgrad_bound(net: dict, points: int) -> float:
    """``wgrad_kernel`` (``chip_smoke.head_dw_rates``): the dW matmuls
    against the bf16 planes it reads, (64 + W) + 2W per trunk layer +
    (W + W/2) lanes a point."""
    W, nb, nt = widths(net)
    planes = points * 2 * ((64 + W) + (nb + nt + 2) * 2 * W + (W + W // 2))
    return bound_ms(trunk_flops_per_point(net) * points, planes)


def train_step_flops(net: dict, R: int, S: int) -> float:
    """Model FLOPs of a training step: forward, input cotangents and
    weight gradients of every point's matmuls, no recomputation."""
    return (2 * trunk_flops_per_point(net) + dx_flops_per_point(net)) * R * S


def render_flops(net: dict, rays: int, S: int) -> float:
    """Model FLOPs of a coarse render: the forward alone."""
    return trunk_flops_per_point(net) * rays * S
