"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
few of the window's steps, reduced to what the per-layer readers and the
result's ``device`` and ``breakdown`` need.

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills) inside the stretch, so work that overlaps on two
  streams counts once;
- ``kernel_s`` / ``kernel_n``: device seconds and launches by name;
- ``idle_gaps``: each gap between busy intervals charged to the
  innermost of the benchmark's own ``record_function`` spans (named
  ``pb.*``) that the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pb."


def span(traced: bool) -> Callable[[str], contextlib.AbstractContextManager]:
    """The span factory of a loop: ``record_function`` while traced, else
    a no-op, so the untraced window pays nothing for them."""
    if traced:
        return torch.profiler.record_function
    return lambda name: contextlib.nullcontext()


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[dict]) -> dict:
    """Reduce Chrome-trace events (times in µs) to the stretch's
    summary."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    for e in dev:
        n = e["name"]
        kernel_s[n] = kernel_s.get(n, 0.0) + e["dur"] * 1e-6
        kernel_n[n] = kernel_n.get(n, 0) + 1
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        inner = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
        who = (min(inner, key=lambda s: s["dur"])["name"] if inner
               else "outside the benchmark's spans")
        gaps[who] = gaps.get(who, 0.0) + (s1 - e0) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernel_s": kernel_s,
        "kernel_n": kernel_n,
        "device_ops": [[n[:200], s] for n, s in top],
        "idle_gaps": [[n, s] for n, s in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def traced(run: Callable[[], None], device: torch.device) -> dict:
    """Run ``run`` under the profiler; the summary plus ``window_s``, the
    stretch's host-clock length ending in a synchronise."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:    # the spans of every thread: the server's handlers, the prefetch
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:
        config = None
    with torch.profiler.profile(activities=acts,
                                experimental_config=config) as prof:
        t0 = time.perf_counter()
        run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = summarize(events)
    out["window_s"] = window_s
    return out


def kernel_seconds(summary: dict, name: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``name``."""
    s = sum(v for k, v in summary["kernel_s"].items() if name in k)
    n = sum(v for k, v in summary["kernel_n"].items() if name in k)
    return s, n
