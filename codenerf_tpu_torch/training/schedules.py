"""Learning-rate schedules (reference ``src/trainer.py:126-131``).

The reference halves the lr every ``interval`` steps but applies it by
rebuilding AdamW every epoch, which zeroes the Adam moments and freezes the
lr for the epoch (its quirk 3). :func:`step_halving` is the continuous
curve; :func:`window_frozen_step_halving` is the reference's effective
schedule under that rebuild, used with ``quirks.optimizer_reset_every``.
"""

from __future__ import annotations


def step_halving(base_lr: float, interval: int):
    """``base_lr * 2^-(step // interval)`` as a function of the 0-based
    step count (the optax schedule of ``codenerf_tpu``)."""

    def schedule(step: int) -> float:
        return base_lr * 2.0 ** (-(step // interval))

    return schedule


def window_frozen_step_halving(base_lr: float, interval: int, window: int):
    """Step-halving evaluated at the start of the enclosing ``window``:
    the decayed lr stays constant for ``window`` steps at a time."""

    def schedule(step: int) -> float:
        return base_lr * 2.0 ** (-(((step // window) * window) // interval))

    return schedule
