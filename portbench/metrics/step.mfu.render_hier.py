"""A served hierarchical render's model FLOPs over the median time the
server held its render lock in the untraced window (``/stats``), as a
share of the H100's dense bf16 peak, in percent. The FLOPs are priced
from the points the program counted through its forward kernels per
render of the window (``RenderServer.timings()["samples"]``): the
sigma-only trunk's matmuls at each coarse point
(``arith.sigma_flops_per_point``) and the whole forward's at each point
of the fine network's four-plane pass (``arith.trunk_flops_per_point``).
None where the program counts no such points (a render through the
plain module)."""

from portbench.harness import arith


def read(r):
    n = r.get("samples_per_render") if r.get("kind") == "serve_hier" \
        else None
    if not n or n.get("planes", 0) <= 0 or r.get("render_ms", 0) <= 0:
        return None
    flops = n.get("coarse_sigma", 0) * arith.sigma_flops_per_point(r["net"]) \
        + n["planes"] * arith.trunk_flops_per_point(r["net"])
    return 100.0 * flops / (r["render_ms"] * 1e-3) / arith.PEAK_BF16_FLOPS
