"""``wgrad_kernel``: each launch's bound (the dW matmuls against the bf16
planes it reads) over its device time in the traced stretch, in
percent."""

from portbench.harness import readers


def read(r):
    return readers.wgrad_roofline(r)
