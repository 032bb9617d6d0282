"""A training step's model FLOPs (forward, input cotangents and weight
gradients of every point's matmuls, no recomputation) per untraced step
time, as a share of the H100's dense bf16 peak, in percent."""

from portbench.harness import readers


def read(r):
    return readers.mfu(r)
