"""Spans on the profiler's clock.

``span(name)`` marks a stretch of host work. While a ``torch.profiler``
is recording it is ``torch.profiler.record_function(name)``: a CPU
annotation in the same trace as the device's kernels, on the same clock,
nested under the enclosing span of its thread. Otherwise it is one shared
no-op context, and costs one read of torch's profiler-enabled flag.
There is no switch: the spans are on exactly while someone profiles, and
the profiler keeps and exports them with the rest of its trace.

The names say the layer first: ``data.*`` (the prefetch pipeline),
``train.*`` and ``step.*`` (the trainer and a step's phases),
``serve.*`` and ``render.*`` (the render server), ``kernels.*`` (the
CUDA kernels' build and load).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A context that records ``name`` (with ``args``, e.g. a request's
    sequence number) while a profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name, args)
    return _OFF
