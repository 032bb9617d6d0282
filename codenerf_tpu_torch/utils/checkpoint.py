"""Checkpoints: the port's training checkpoints, and interchange in the
reference's torch formats.

Training checkpoints (counterpart of ``codenerf_tpu/utils/checkpoint.py``,
which writes Orbax directories): the whole training state in one
``torch.save`` file per step, ``<ckpt_dir>/step_NNNNNNNN.pt`` — model,
both code tables, AdamW state, step and the z-jitter generator's state —
so a resumed run continues exactly where the saved one stopped. The
logical keys correspond to the reference's ``models.pth``:

  model          <-> model_params
  shape_codes    <-> shape_code_params['weight']
  texture_codes  <-> texture_code_params['weight']
  step           <-> niter

Reference formats:

- ``models.pth`` (``src/trainer.py:165-174``): ``{model_params,
  shape_code_params: {weight}, texture_code_params: {weight}, niter,
  nepoch}`` with the reference layer names — what
  ``tools/export_reference_checkpoint.py`` writes from a JAX run.
- ``codes.pth`` (``src/optimizer.py:137-147``): the optimized codes and
  per-object-index PSNR/SSIM lists.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from codenerf_tpu_torch.models.codenerf import (load_reference_state_dict,
                                                to_reference_state_dict)

_STEP_RE = re.compile(r"^step_(\d{8})\.pt$")


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def save_checkpoint(ckpt_dir: str, state) -> str:
    """Write ``state`` (a ``training.state.TrainState``) at its step; the
    file appears whole or not at all."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = step_path(ckpt_dir, state.step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({
        "model": state.model.state_dict(),
        "shape_codes": state.shape_codes.detach(),
        "texture_codes": state.texture_codes.detach(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def _load(ckpt_dir: str, step: Optional[int], map_location) -> dict:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
    return torch.load(step_path(ckpt_dir, step), map_location=map_location,
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load a checkpoint (the latest when ``step`` is None) into ``state``
    in place, on the state's device; returns ``state``. The file is read
    on the CPU: ``load_state_dict`` moves the parameters and the Adam
    moments to their device but leaves AdamW's step counters where it
    finds them, and counters on the card cost a synchronization each
    per step."""
    ck = _load(ckpt_dir, step, "cpu")
    state.model.load_state_dict(ck["model"])
    with torch.no_grad():
        state.shape_codes.copy_(ck["shape_codes"])
        state.texture_codes.copy_(ck["texture_codes"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    state.generator.set_state(ck["generator"].cpu())
    return state


def load_training_checkpoint(ckpt_dir: str, step: Optional[int] = None
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        torch.Tensor, torch.Tensor]:
    """A training checkpoint read blind (the optimize CLI does not know the
    training-time object count): (``CodeNeRF`` state dict, shape code table
    (N, D), texture code table (N, D)), float32 on the CPU — the same
    triple as :func:`load_reference_checkpoint`."""
    ck = _load(ckpt_dir, step, "cpu")
    return ({k: v.float() for k, v in ck["model"].items()},
            ck["shape_codes"].float(), ck["texture_codes"].float())


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         torch.Tensor, torch.Tensor]:
    """``models.pth`` -> (``CodeNeRF`` state dict, shape code table (N, D),
    texture code table (N, D)), all float32 on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return (load_reference_state_dict(ckpt["model_params"]),
            ckpt["shape_code_params"]["weight"].float(),
            ckpt["texture_code_params"]["weight"].float())


def save_reference_checkpoint(path: str, model, shape_codes: torch.Tensor,
                              texture_codes: torch.Tensor, niter: int = 0,
                              nepoch: int = 0) -> None:
    """Write ``models.pth`` in the reference layout."""
    torch.save({
        "model_params": to_reference_state_dict(model),
        "shape_code_params": {"weight": shape_codes.detach().float().cpu()},
        "texture_code_params": {
            "weight": texture_codes.detach().float().cpu()},
        "niter": int(niter),
        "nepoch": int(nepoch),
    }, path)


def save_reference_codes(path: str, ids, num_obj: int, shape_codes,
                         texture_codes, psnr_eval, ssim_eval) -> None:
    """Write the reference ``Optimizer``'s ``codes.pth`` payload:
    ``psnr_eval`` / ``ssim_eval`` map int object index -> per-view values."""
    torch.save({
        "ids": np.asarray(ids),
        "num_obj": int(num_obj),
        "optimized_shapecodes": torch.from_numpy(
            np.asarray(shape_codes, dtype=np.float32)),
        "optimized_texturecodes": torch.from_numpy(
            np.asarray(texture_codes, dtype=np.float32)),
        "psnr_eval": {int(k): [float(x) for x in v]
                      for k, v in psnr_eval.items()},
        "ssim_eval": {int(k): [float(x) for x in v]
                      for k, v in ssim_eval.items()},
    }, path)
