"""``trunk_fwd_kernel`` in training: each launch's bound at its own shape
(the weight-gradient mode) over the kernel's device time in the traced
stretch, in percent."""

from portbench.harness import readers


def read(r):
    return readers.trunk_fwd_roofline(r, readers.TRAIN_MODES, True)
