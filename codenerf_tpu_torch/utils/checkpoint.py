"""Checkpoint interchange in the reference's torch formats.

- ``models.pth`` (``src/trainer.py:165-174``): ``{model_params,
  shape_code_params: {weight}, texture_code_params: {weight}, niter,
  nepoch}`` with the reference layer names — what
  ``tools/export_reference_checkpoint.py`` writes from a JAX run.
- ``codes.pth`` (``src/optimizer.py:137-147``): the optimized codes and
  per-object-index PSNR/SSIM lists.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from codenerf_tpu_torch.models.codenerf import (load_reference_state_dict,
                                                to_reference_state_dict)


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
