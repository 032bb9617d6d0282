"""What a cell's kind module is given and what it gives back, and the
arithmetic of the comparison that decides ``correct``."""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Context:
    cell: str
    config: dict          # portbench/configs/<config>.json
    traffic: dict         # portbench/traffic/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float        # perf_counter at the process's start
    workdir: str          # scratch under TMPDIR, removed after the run

    def sub_seed(self, k: int) -> int:
        """A seed of its own for the k-th stream drawn from ``--seed``."""
        return (self.seed * 1_000_003 + k) % (1 << 63)


class Parts:
    """Host-clock seconds of set-up's parts, for the run's notes: each
    :meth:`mark` closes the part since the previous one."""

    def __init__(self, t0: float):
        self.t, self.seconds = t0, {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now

    def __str__(self) -> str:
        return "set-up parts (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.seconds.items())


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: it passes when it is finite
    and at most the limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    setup_s: float
    e2e: Dict[str, float]          # the host-clock metrics besides setup_s
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    readings: dict                 # what the per-layer readers read (with
    #                                harness/trace.py's summary: "trace")
    notes: List[str] = dataclasses.field(default_factory=list)


def sync(dev: torch.device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def checks_from(readings: Dict[str, float], limits: Dict[str, float]
                ) -> List[Check]:
    """One :class:`Check` per limit of the traffic file; a reading that is
    missing counts as failed."""
    return [Check(k, float(readings.get(k, math.inf)), float(v))
            for k, v in limits.items()]


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = list(ref) if keep is None else keep
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[List[str]] = None) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(leaf_gaps(prog, ref, keep).values())


def moved_leaves(grad1: Dict[str, float]) -> List[str]:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's: the others move under AdamW by round-off alone
    and are left out of the change."""
    med = statistics.median(grad1.values())
    return [n for n, g in grad1.items() if g >= 1e-3 * med]
