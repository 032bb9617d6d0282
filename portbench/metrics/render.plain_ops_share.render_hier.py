"""The share of a served hierarchical render's device time spent in
operations other than the port's own CUDA kernels (the compositing
weights, the inverse-CDF resample and the sort, gathers, copies, fills
and the prologue's matrix products), over the device's busy time in the
traced stretch, in percent. A render through the plain module reads
near 100."""

from portbench.harness import readers

# The kernels of the port's CUDA sources (codenerf_tpu_torch/ops/csrc),
# matched by name; "head_kernel" matches the sigma and plane heads too.
PORT_KERNELS = ("trunk_fwd_kernel", "trunk_dx_kernel", "head_kernel",
                "wgrad_kernel", "fixed_sum_kernel", "composite_kernel",
                "input_chain_kernel", "ray_sum_fold_kernel", "pack_kernel",
                "code_row_tiles_kernel", "code_row_fold_kernel")


def read(r):
    if r.get("kind") != "serve_hier" or not readers.traced(r):
        return None
    plain = sum(s for name, s in r["trace"]["kernel_s"].items()
                if not any(k in name for k in PORT_KERNELS))
    return 100.0 * plain / r["trace"]["busy_s"]
