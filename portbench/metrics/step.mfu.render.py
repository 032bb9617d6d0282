"""A served render's model FLOPs (the forward's matmuls at every sample
of every ray, ``harness/arith.render_flops``) over the median time the
server held its render lock in the untraced window (``/stats``), as a
share of the H100's dense bf16 peak, in percent."""

from portbench.harness import arith


def read(r):
    if r.get("kind") != "serve" or r.get("render_ms", 0) <= 0:
        return None
    return 100.0 * r["render_flops"] / (r["render_ms"] * 1e-3) \
        / arith.PEAK_BF16_FLOPS
