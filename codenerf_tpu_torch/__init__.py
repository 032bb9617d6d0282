"""CodeNeRF in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``codenerf_tpu`` (JAX on a TPU). Module names mirror the JAX
package so each counterpart is easy to find; the JAX package stays the
reference that every module here is tested against. Nothing here imports
``jax`` or ``codenerf_tpu``.

Two paths are ported, both coarse-only at the flagship widths:

- category training (``python -m codenerf_tpu_torch.train``, ``Trainer``):
  each step runs the single-pass kernel (``ops/fused_train.py``, CUDA
  source ``ops/csrc/train_fused.cu``) in its weight-gradient mode, which
  returns the loss, the code cotangents and every weight's gradient;
  configs without ``use_fused_train`` take the autodiff route;
- test-time code optimization + eval (``python -m
  codenerf_tpu_torch.optimize``, reading the training run's ``ckpt/``):
  the same kernel frozen drives each optimization step, and eval renders
  through the plain ``CodeNeRF`` module.

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
