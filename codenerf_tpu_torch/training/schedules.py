"""Learning-rate schedules (reference ``src/trainer.py:126-131``)."""

from __future__ import annotations


def step_halving(base_lr: float, interval: int):
    """``base_lr * 2^-(step // interval)`` as a function of the 0-based
    step count (the optax schedule of ``codenerf_tpu``)."""

    def schedule(step: int) -> float:
        return base_lr * 2.0 ** (-(step // interval))

    return schedule
