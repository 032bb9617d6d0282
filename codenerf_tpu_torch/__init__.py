"""CodeNeRF in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``codenerf_tpu`` (JAX on a TPU). Module names mirror the JAX
package so each counterpart is easy to find; the JAX package stays the
reference that every module here is tested against. Nothing here imports
``jax`` or ``codenerf_tpu``.

This slice covers the test-time code optimization + eval path
(``python -m codenerf_tpu_torch.optimize``): the frozen-model single-pass
kernel (``ops/fused_train.py``, CUDA source in ``ops/csrc/``) drives each
optimization step, and eval renders through the plain ``CodeNeRF`` module.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; requesting CUDA where there is none raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point. Never falls back: a CUDA
    request on a machine without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
