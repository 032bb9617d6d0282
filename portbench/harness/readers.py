"""What the per-layer readers (``portbench/metrics/<name>.py``) share.
Each takes the run's readings (a kind module's ``Outcome.readings``) and
returns a number, or None where the run gave it nothing to read: never a
0 for a share of a roofline or a peak."""

from portbench.harness import arith, trace

TRAIN_MODES = ("train",)


def traced(r) -> bool:
    return bool(r.get("trace")) and r["trace"]["busy_s"] > 0


def idle_share(r):
    """One less the union of the device's operation intervals per traced
    step over the untraced window's host time per step, in percent."""
    if not traced(r):
        return None
    busy = r["trace"]["busy_s"] / r["steps_traced"]
    return 100.0 * (1.0 - busy / r["step_s"])


def mfu(r):
    """A step's model FLOPs per untraced step time over the dense bf16
    peak, in percent."""
    return 100.0 * r["step_flops"] / r["step_s"] / arith.PEAK_BF16_FLOPS


def trunk_fwd_roofline(r, modes, weight_grads: bool):
    """``trunk_fwd_kernel``: the sum of each launch's bound over the sum
    of its device time in the traced stretch, in percent. Its callers are
    the single-pass ``modes`` (``arith.trunk_fwd_bound``), priced at the
    points the program's counters counted; nothing is read where the
    trace holds launches they did not count."""
    if not traced(r):
        return None
    s, n = trace.kernel_seconds(r["trace"], "trunk_fwd_kernel")
    if n == 0 or s <= 0 or n != sum(r["launches"].get(m, 0) for m in modes):
        return None
    bound_ms = arith.trunk_fwd_bound(
        r["net"], sum(r["points"].get(m, 0) for m in modes), weight_grads)
    return 100.0 * bound_ms * 1e-3 / s


def wgrad_roofline(r):
    """``wgrad_kernel``: each launch's bound (``arith.wgrad_bound`` at the
    training modes' counted points) over its device time, in percent."""
    if not traced(r):
        return None
    s, n = trace.kernel_seconds(r["trace"], "wgrad_kernel")
    if n == 0 or s <= 0 or n != sum(r["launches"].get(m, 0)
                                    for m in TRAIN_MODES):
        return None
    points = sum(r["points"].get(m, 0) for m in TRAIN_MODES)
    return 100.0 * arith.wgrad_bound(r["net"], points) * 1e-3 / s
