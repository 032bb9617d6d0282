"""Checkpoints: the port's training checkpoints, and interchange in the
reference's torch formats.

Training checkpoints (counterpart of ``codenerf_tpu/utils/checkpoint.py``,
which writes Orbax directories): the whole training state in one
``torch.save`` file per step, ``<ckpt_dir>/step_NNNNNNNN.pt`` — model,
both code tables, AdamW state, step and the z-jitter generator's state —
so a resumed run continues exactly where the saved one stopped. A state
split over a mesh's ``model`` axis is saved whole — every rank joins one
gather of its slices (weights, tables, AdamW moments), the writer saves —
and a whole checkpoint is restored into such a state by slicing, so a run
resumes across any ``model`` size. The logical keys correspond to the
reference's ``models.pth``:

  model          <-> model_params
  shape_codes    <-> shape_code_params['weight']
  texture_codes  <-> texture_code_params['weight']
  step           <-> niter

Reference formats:

- ``models.pth`` (``src/trainer.py:165-174``): ``{model_params,
  shape_code_params: {weight}, texture_code_params: {weight}, niter,
  nepoch}`` with the reference layer names — what
  ``tools/export_reference_checkpoint.py`` writes from a JAX run and
  ``python -m codenerf_tpu_torch.export_reference_checkpoint`` from a
  port run.
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


def _leaves(payload: dict, names) -> list:
    """``(container, key, name)`` for every trainable and AdamW moment of
    a checkpoint payload, ``name`` the trainable's
    (``training.state.named_trainables``; ``names`` lists them in the
    optimizer's order). The optimizer's per-parameter dicts are copied
    first, so writing through a container leaves the live optimizer
    alone."""
    out = []
    for key in ("model", "fine_model"):
        for n in payload[key] or {}:
            out.append((payload[key], n, f"{key}.{n}"))
    out += [(payload, n, n) for n in ("shape_codes", "texture_codes")]
    state = payload["optimizer"]["state"]
    for i, name in enumerate(names):
        if i in state:
            state[i] = dict(state[i])
            out += [(state[i], k, name) for k in ("exp_avg", "exp_avg_sq")
                    if k in state[i]]
    return out


def _reshard(payload: dict, state, gather: bool) -> dict:
    """``payload`` with the sharded leaves of ``state`` 's model axis
    gathered whole (``gather``; one collective) or sliced to this rank's
    blocks."""
    from codenerf_tpu_torch.training.state import named_trainables

    sh = state.shards
    jobs = [(c, k, sh.dims.get(n)) for c, k, n in
            _leaves(payload, list(named_trainables(state)))
            if sh.dims.get(n) is not None]
    if gather:
        new = sh.gather([c[k] for c, k, _ in jobs], [d for *_, d in jobs])
    else:
        new = [sh.slice(c[k], d) for c, k, d in jobs]
    for (c, k, _), t in zip(jobs, new):
        c[k] = t
    return payload


def save_checkpoint(ckpt_dir: str, state, write: bool = True
                    ) -> Optional[str]:
    """Write ``state`` (a ``training.state.TrainState``) at its step; the
    file appears whole or not at all. Under a ``model`` axis every rank
    calls this (the gather), and those with ``write`` False write nothing
    and return None."""
    if state.shards is None and not write:
        return None
    payload = {
        "model": state.model.state_dict(),
        "fine_model": (None if state.fine_model is None
                       else state.fine_model.state_dict()),
        "shape_codes": state.shape_codes.detach(),
        "texture_codes": state.texture_codes.detach(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }
    if state.shards is not None:
        with torch.no_grad():
            payload = _reshard(payload, state, gather=True)
    if not write:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    path = step_path(ckpt_dir, state.step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
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


def read_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The payload of a training checkpoint (the latest when ``step`` is
    None) as :func:`save_checkpoint` wrote it, read on the CPU."""
    return _load(ckpt_dir, step, "cpu")


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load a checkpoint (the latest when ``step`` is None) into ``state``
    in place, on the state's device; returns ``state``. The file is read
    on the CPU: ``load_state_dict`` moves the parameters and the Adam
    moments to their device but leaves AdamW's step counters where it
    finds them, and counters on the card cost a synchronization each
    per step. A state split over a ``model`` axis takes its slices of the
    whole checkpoint."""
    ck = _load(ckpt_dir, step, "cpu")
    if state.shards is not None:
        ck = _reshard(ck, state, gather=False)
    state.model.load_state_dict(ck["model"])
    if (state.fine_model is None) != (ck.get("fine_model") is None):
        raise ValueError(f"{ckpt_dir}: the checkpoint's fine network and the "
                         "state's do not match (hierarchical_share_weights)")
    if state.fine_model is not None:
        state.fine_model.load_state_dict(ck["fine_model"])
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
    triple as :func:`load_reference_checkpoint`. The fine network, if the
    run has one, is :func:`load_run`'s."""
    ck = _load(ckpt_dir, step, "cpu")
    return ({k: v.float() for k, v in ck["model"].items()},
            ck["shape_codes"].float(), ck["texture_codes"].float())


def load_run(run_dir: str, hp, device):
    """The trained networks and code tables of a run directory, for the
    optimize and pose CLIs: the latest ``<run_dir>/ckpt/step_*.pt``, else
    ``<run_dir>/models.pth`` (reference layout). Returns ``(model,
    fine_model, shape_codes, texture_codes)``: the networks frozen on
    ``device``, ``fine_model`` None unless ``hp`` has separate fine
    weights (which a ``models.pth`` cannot hold), the tables on the
    CPU."""
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.training.state import needs_fine_model

    ckpt_dir = os.path.join(run_dir, "ckpt")
    fine_sd = None
    if latest_step(ckpt_dir) is not None:
        ck = _load(ckpt_dir, None, "cpu")
        sd, sc, tc = ck["model"], ck["shape_codes"], ck["texture_codes"]
        fine_sd = ck.get("fine_model")
    else:
        sd, sc, tc = load_reference_checkpoint(os.path.join(run_dir,
                                                            "models.pth"))

    def net(state_dict):
        m = CodeNeRF(hp.net)
        m.load_state_dict({k: v.float() for k, v in state_dict.items()})
        return m.to(device).requires_grad_(False)

    fine = None
    if needs_fine_model(hp):
        if fine_sd is None:
            raise ValueError(
                f"{run_dir} holds no fine network, and the jsonfile asks "
                "for separate fine weights (hierarchical_share_weights: "
                "false)")
        fine = net(fine_sd)
    return net(sd), fine, sc.float(), tc.float()


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
