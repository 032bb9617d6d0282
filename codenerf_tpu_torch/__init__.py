"""CodeNeRF in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``codenerf_tpu`` (JAX on a TPU). Module names mirror the JAX
package so each counterpart is easy to find; the JAX package stays the
reference that every module here is tested against. Nothing here imports
``jax`` or ``codenerf_tpu``.

Two paths are ported at the flagship widths, coarse and hierarchical:

- category training (``python -m codenerf_tpu_torch.train``, ``Trainer``):
  each step runs the single-pass kernel (``ops/fused_train.py``, CUDA
  source ``ops/csrc/train_fused.cu``) in its weight-gradient mode, which
  returns the loss, the code cotangents and every weight's gradient;
  configs without ``use_fused_train`` take the autodiff route;
- test-time code optimization + eval (``python -m
  codenerf_tpu_torch.optimize``, reading the training run's ``ckpt/``):
  the same kernel frozen drives each optimization step, and eval renders
  through the plain ``CodeNeRF`` module.

With hierarchical sampling (``N_importance > 0``, shared fine weights;
``jsonfiles/srncar_hier_occ.json``) both paths run a sigma-only coarse
forward (``ops/fused_mlp.sigma_fwd``) and then the single-pass kernel in
its dual-composite mode at the union of the coarse and fine depths; sphere
bounds and the occupancy grid (``core/occupancy.py``) tighten each ray's
sampled span. Joint pose and code optimization (``python -m
codenerf_tpu_torch.pose_opt``) runs the kernel's pose modes.

The plane-op route serves what the single pass does not: separate fine
weights, ``fused_composite: false`` and code-optimization chunks that need
padding. Its op (``ops/fused_train.PlaneOp``) is the four-plane forward
(``ops/fused_mlp.planes_fwd``) and a backward that recomputes it and
takes the planes' cotangents (``fused_train.plane_bwd``), under the
PyTorch composite or chained into the standalone composite kernel
(``ops/composite.py``). Every TPU kernel of the JAX package has its CUDA
counterpart in ``ops/csrc/train_fused.cu``.

The user-facing tools: ``python -m
codenerf_tpu_torch.export_reference_checkpoint`` (a run's checkpoint as a
reference ``models.pth``) and, reading a trained run through
``utils/checkpoint.load_run`` and rendering through
``renderer.render_image`` (on the card the forward kernels where they
take the render, else the plain module, as the JAX package renders
through XLA), ``.edit`` (code interpolation and
the shape × texture swap matrix, ``optimization/editing.py``),
``.render_orbit``, ``.serve`` (the HTTP render service,
``serving.RenderServer``) and ``.estimate_bound_radius``.

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
