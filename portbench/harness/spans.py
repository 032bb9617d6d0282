"""The program's own spans and counters, as the benchmark would read them.

The port records its spans (``codenerf_tpu_torch/utils/tracing.py``:
``data.*``, ``train.*``, ``step.*``, ``serve.*``, ``render.*``,
``kernels.*``) whenever a profiler records, and keeps counters always:
the prefetch pipeline's ``counters``, the train step's ``counters``, the
server's ``timings()`` and ``ops/_build.counters``. This module holds:

- :func:`program_gaps`: each idle gap of a traced stretch charged to the
  innermost program span that the thread issuing the first kernel after
  the gap was in at the gap's middle, or, where that thread was in none
  (autograd's backward thread, or a server's next request on a thread of
  its own), to the innermost that any thread was in;
- the snapshots of the counters around an untraced window, and the four
  readings that come from them, each None where the program keeps no
  such counter (a checkout older than its counters).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from portbench.harness import trace

PROGRAM_PREFIXES = ("data.", "train.", "step.", "serve.", "render.",
                    "kernels.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the program's spans"


def _runs(dev: List[dict]):
    """The busy intervals (the union of ``dev``'s), each with the
    operation that opened it: ``[start, end, op]``."""
    out = []
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t, e])
    return out


def _around(spans: List[dict], t: float) -> List[dict]:
    return [s for s in spans if s["ts"] <= t <= s["ts"] + s["dur"]]


def program_gaps(events: List[dict]) -> Dict[str, float]:
    """Seconds of idle device time by program span, from Chrome-trace
    events (times in µs). A gap belongs to the thread that launched the
    first kernel after it (matched by ``correlation``), and to the
    innermost of that thread's program spans around the gap's middle;
    where it was in none, to the innermost of every thread's. Copies and
    fills are passed over: the prefetch worker stages batches while the
    step's thread falls behind, and its copy may end a gap that thread
    left."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in trace.DEVICE_CATS]
    issuer = {e["args"]["correlation"]: e["tid"] for e in events
              if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    spans: Dict[object, List[dict]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and str(e.get("name", "")).startswith(PROGRAM_PREFIXES):
            spans.setdefault(e["tid"], []).append(e)
    kernels = sorted((e for e in dev if e["cat"] == "kernel"),
                     key=lambda e: e["ts"])
    starts = [e["ts"] for e in kernels]
    every = [s for ss in spans.values() for s in ss]
    gaps: Dict[str, float] = {}
    runs = _runs(dev)
    for (_, e0, _), (s1, _, op) in zip(runs, runs[1:]):
        mid = 0.5 * (e0 + s1)
        k = bisect.bisect_left(starts, s1)
        if k < len(kernels):
            op = kernels[k]
        tid = issuer.get(op.get("args", {}).get("correlation"))
        inner = _around(spans.get(tid, ()), mid) or _around(every, mid)
        who = min(inner, key=lambda s: s["dur"])["name"] if inner \
            else OUTSIDE
        gaps[who] = gaps.get(who, 0.0) + (s1 - e0) * 1e-6
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def gap_notes(gaps: Dict[str, float], window_s: float) -> List[str]:
    """One line a span: its idle seconds and their share of the traced
    stretch."""
    return [f"idle in program span {name}: {s:.6f} s, "
            f"{100.0 * s / window_s:.3f}% of the stretch"
            for name, s in gaps.items()]


def train_counters(trainer) -> Optional[dict]:
    """The trainer's data-wait and step counters, copied; None where the
    program has neither."""
    pipe = getattr(trainer.pipeline, "counters", None)
    step = getattr(trainer._train_step, "counters", None)
    if pipe is None or step is None:
        return None
    return {"wait_s": pipe["wait_s"], "batches": pipe["batches"],
            "host_s": step["host_s"], "steps": step["steps"]}


def train_readings(before: Optional[dict], after: Optional[dict]) -> dict:
    """``data_wait_s``, ``step_host_s`` and ``window_steps`` over a window
    between two :func:`train_counters` snapshots; empty without them."""
    if before is None or after is None:
        return {}
    return {"data_wait_s": after["wait_s"] - before["wait_s"],
            "step_host_s": after["host_s"] - before["host_s"],
            "window_steps": after["steps"] - before["steps"]}


def serve_readings(server) -> dict:
    """``queue_ms`` and ``handler_ms``, the p50s of the server's
    ``timings()``; empty where the server has none."""
    timings = getattr(server, "timings", None)
    if timings is None:
        return {}
    t = timings()
    return {"queue_ms": t["queue_ms"]["p50"],
            "handler_ms": t["handler_ms"]["p50"]}


def data_wait_share(r) -> Optional[float]:
    """The training loop's wait on the prefetch queue over the untraced
    window's host time, in percent."""
    if r.get("kind") != "train" or not r.get("window_steps") \
            or "data_wait_s" not in r:
        return None
    return 100.0 * r["data_wait_s"] / (r["step_s"] * r["window_steps"])


def step_host_ms(r) -> Optional[float]:
    """The host ms a step spends inside the train step's call (issuing
    its work, and any wait inside it) over the untraced window."""
    if r.get("kind") != "train" or not r.get("window_steps") \
            or "step_host_s" not in r:
        return None
    return 1e3 * r["step_host_s"] / r["window_steps"]


def queue_ms(r) -> Optional[float]:
    """The p50 wait for the server's render lock, untraced window."""
    return r.get("queue_ms") if r.get("kind") == "serve" else None


def handler_ms(r) -> Optional[float]:
    """The p50 of a request's handler work outside the render lock
    (parse, PNG encode, reply), untraced window."""
    return r.get("handler_ms") if r.get("kind") == "serve" else None


READINGS = {"data.wait_share.train": data_wait_share,
            "step.host_ms.train": step_host_ms,
            "serving.queue_ms": queue_ms,
            "serving.handler_ms": handler_ms}
