"""The device's idle share of a training step: one less the union of its
operations' intervals per traced step over the untraced window's host
time per step, in percent."""

from portbench.harness import readers


def read(r):
    return readers.idle_share(r)
