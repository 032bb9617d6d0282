"""Bounds of ``trunk_fwd_kernel`` in the two forward-only modes a
hierarchical render launches, beside ``arith.py`` (frozen), whose
operation counts and peaks they use.

- the sigma-only forward (``sigma_fwd``): the PE, the shape blocks and
  enc_shape (``arith.sigma_flops_per_point``); it reads each point's
  depth and writes t (W bf16 lanes) for the sigma head;
- the four-plane forward (``planes_fwd``): the whole trunk through
  rgb_hidden (``arith.trunk_flops_per_point``); it reads each point's
  depth and writes t and r (W + W/2 bf16 lanes) for the four-plane head.

Neither mode writes masks or dW inputs: nothing is kept for a backward.
Per launch of R rays, both read the rays' origins and directions (8 f32
lanes each) and the code projections the trunk injects (bf16, W lanes a
block), the four-plane forward also the viewdir rows (W bf16), and the
trunk's weights once (bf16). A bound is the larger of the operations at
the dense bf16 peak and the bytes at the HBM rate, in milliseconds.
"""

from __future__ import annotations

from portbench.harness import arith
from portbench.reference.codenerf import layer_shapes

SIGMA_LAYERS = ("enc_xyz", "shape_", "enc_shape")


def _weight_bytes(net: dict, sigma_only: bool) -> int:
    """The trunk's matmul weights and biases the mode reads, bf16 (the
    code projections and the heads are read elsewhere)."""
    trunk = [s for s in layer_shapes(net) if s[0] not in
             ("sigma", "rgb_out") and "latent" not in s[0]]
    if sigma_only:
        trunk = [s for s in trunk if s[0].startswith(SIGMA_LAYERS)]
    return 2 * sum(o * (i + 1) for _, i, o in trunk)


def trunk_fwd_bound(net: dict, launches: int, points: int, S: int,
                    sigma_only: bool) -> float:
    """The sum of the bounds of ``launches`` launches of ``S`` samples a
    ray over ``points`` points in all, each launch of the same shape."""
    if launches <= 0 or points <= 0:
        return 0.0
    W, nb, nt = arith.widths(net)
    P = points / launches
    R = P / S
    flops = (arith.sigma_flops_per_point(net) if sigma_only
             else arith.trunk_flops_per_point(net)) * P
    point_b = 4 + 2 * W * (1 if sigma_only else 1.5)
    ray_b = 2 * 8 * 4 + 2 * W * (nb if sigma_only else nb + nt + 1)
    nbytes = point_b * P + ray_b * R + _weight_bytes(net, sigma_only)
    return launches * arith.bound_ms(flops, nbytes)
