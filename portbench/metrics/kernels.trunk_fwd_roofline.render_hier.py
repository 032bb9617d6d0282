"""``trunk_fwd_kernel`` in served hierarchical renders: the sum of each
launch's bound at its own mode and shape (the sigma-only forward at the
coarse depths, the four-plane forward at the union;
``harness/arith_hier.trunk_fwd_bound``, priced at the launches and
points the program's counters counted in the traced stretch) over the
kernel's device time there, in percent. None where the trace holds
launches the counters did not count, or none at all."""

from portbench.harness import arith_hier, readers, trace


def read(r):
    if r.get("kind") != "serve_hier" or not readers.traced(r):
        return None
    s, n = trace.kernel_seconds(r["trace"], "trunk_fwd_kernel")
    launches, points = r.get("launches", {}), r.get("points", {})
    if n == 0 or s <= 0 or n != sum(launches.values()):
        return None
    hp = r["hparams"]
    union = hp["N_samples"] + hp["N_importance"]
    bound_ms = arith_hier.trunk_fwd_bound(
        r["net"], launches.get("sigma", 0), points.get("sigma", 0),
        hp["N_samples"], True) + arith_hier.trunk_fwd_bound(
        r["net"], launches.get("planes", 0), points.get("planes", 0),
        union, False)
    return 100.0 * bound_ms * 1e-3 / s
