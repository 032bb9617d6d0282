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
resumes across any ``model`` size.

A run that fails under a ``model`` axis cannot gather (a peer may be
dead), so each rank writes its own slices instead, with no collective
(:func:`save_slices`): ``step_NNNNNNNN.rank<r>of<w>.model<m>.pt`` holds
its blocks of the sharded leaves and their AdamW moments, the replicated
leaves, the step, the generator and the layout. A step counts as saved
once every rank's slice file of that step and layout is there; readers
(:func:`latest_step`, :func:`read_checkpoint`,
:func:`restore_checkpoint`, :func:`load_run`) take the newest step saved
either way and stitch a complete set of slices into a whole checkpoint,
so a crashed run resumes in its layout or in one process. Ranks that
stopped on different steps leave incomplete sets; the readers pass over
them to the newest complete checkpoint and say which they took
(:func:`checkpoint_note`, logged by the trainer's resume).

The logical keys correspond to the reference's ``models.pth``:

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
_SLICE_RE = re.compile(r"^step_(\d{8})\.rank(\d+)of(\d+)\.model(\d+)\.pt$")


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


def _payload(state) -> dict:
    return {
        "model": state.model.state_dict(),
        "fine_model": (None if state.fine_model is None
                       else state.fine_model.state_dict()),
        "shape_codes": state.shape_codes.detach(),
        "texture_codes": state.texture_codes.detach(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }


def _write(path: str, payload: dict) -> str:
    """``payload`` at ``path``, whole or not at all (a temporary name,
    then a rename)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_slices(ckpt_dir: str, state) -> str:
    """This rank's slices of a state split over a ``model`` axis, at its
    step, with no collective (a crashed run's save): its blocks of the
    sharded leaves and their moments, the replicated leaves, the step,
    the generator, and the layout — global rank and world size, the
    ``model`` size, this rank's place in its ``model`` group and the
    group's global ranks. Returns the path."""
    import torch.distributed as dist

    from codenerf_tpu_torch.training.state import named_trainables

    sh = state.shards
    rank, world = dist.get_rank(), dist.get_world_size()
    payload = _payload(state)
    payload["slices"] = {
        "rank": rank, "world": world, "model": sh.size,
        "model_rank": sh.rank,
        "model_group": dist.get_process_group_ranks(sh.group),
        "names": list(named_trainables(state)), "dims": dict(sh.dims)}
    name = f"step_{state.step:08d}.rank{rank}of{world}.model{sh.size}.pt"
    return _write(os.path.join(ckpt_dir, name), payload)


def _slice_sets(ckpt_dir: str) -> Dict[int, Dict[tuple, Dict[int, str]]]:
    """step -> (world, model) -> global rank -> the slice files there."""
    out: Dict[int, Dict[tuple, Dict[int, str]]] = {}
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = _SLICE_RE.match(name)
            if m:
                step, rank, world, model = map(int, m.groups())
                out.setdefault(step, {}).setdefault((world, model), {})[
                    rank] = os.path.join(ckpt_dir, name)
    return out


def _complete_slices(ckpt_dir: str) -> Dict[int, Dict[int, str]]:
    """step -> the slice files of a layout in which every rank saved
    it (rank -> path)."""
    out = {}
    for step, layouts in _slice_sets(ckpt_dir).items():
        for (world, _), files in sorted(layouts.items()):
            if set(files) == set(range(world)):
                out[step] = files
    return out


def _whole_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for name in os.listdir(ckpt_dir)
            if (m := _STEP_RE.match(name))]


def checkpoint_note(ckpt_dir: str) -> Optional[str]:
    """Which checkpoint the readers take when slice sets newer than it
    are incomplete (ranks that stopped on different steps): the step,
    its kind and the passed-over sets; None when nothing newer was passed
    over."""
    step = latest_step(ckpt_dir)
    skipped = {s: {f"{w} ranks, model {m}": sorted(files)
                   for (w, m), files in layouts.items()}
               for s, layouts in _slice_sets(ckpt_dir).items()
               if step is None or s > step}
    if not skipped:
        return None
    kind = ("none" if step is None else "whole"
            if step in _whole_steps(ckpt_dir) else "stitched from slices")
    passed = "; ".join(f"step {s}: slices of ranks {v}" for s, v in
                       sorted(skipped.items(), reverse=True))
    return (f"{ckpt_dir}: the newest complete checkpoint is step {step} "
            f"({kind}); passed over incomplete slice sets ({passed})")


def _stitch(files: Dict[int, str], map_location) -> dict:
    """A whole checkpoint payload from a complete set of slice files: the
    ``model`` group of global rank 0, its blocks concatenated on each
    leaf's sharded dimension in the group's order."""
    first = torch.load(files[0], map_location=map_location,
                       weights_only=True)
    info = first["slices"]
    group = [first if r == 0 else torch.load(
        files[r], map_location=map_location, weights_only=True)
        for r in info["model_group"]]
    group.sort(key=lambda p: p["slices"]["model_rank"])
    names, dims = info["names"], info["dims"]
    leaves = [_leaves(p, names) for p in group]
    for i, (c, k, name) in enumerate(leaves[0]):
        if dims.get(name) is not None:
            c[k] = torch.cat([lv[i][0][lv[i][1]] for lv in leaves],
                             dims[name])
    del first["slices"]
    return first


def save_checkpoint(ckpt_dir: str, state, write: bool = True
                    ) -> Optional[str]:
    """Write ``state`` (a ``training.state.TrainState``) at its step; the
    file appears whole or not at all. Under a ``model`` axis every rank
    calls this (the gather), and those with ``write`` False write nothing
    and return None."""
    if state.shards is None and not write:
        return None
    payload = _payload(state)
    if state.shards is not None:
        with torch.no_grad():
            payload = _reshard(payload, state, gather=True)
    if not write:
        return None
    return _write(step_path(ckpt_dir, state.step), payload)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step saved whole or as a complete set of slices."""
    steps = _whole_steps(ckpt_dir) + list(_complete_slices(ckpt_dir))
    return max(steps) if steps else None


def _load(ckpt_dir: str, step: Optional[int], map_location) -> dict:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
    path = step_path(ckpt_dir, step)
    if not os.path.exists(path):
        files = _complete_slices(ckpt_dir).get(step)
        if files is not None:
            return _stitch(files, map_location)
    return torch.load(path, map_location=map_location, weights_only=True)


def read_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The payload of a training checkpoint (the latest when ``step`` is
    None) as :func:`save_checkpoint` wrote it, read on the CPU (a
    complete set of slices stitched whole)."""
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
    optimize and pose CLIs: the latest checkpoint of ``<run_dir>/ckpt/``
    (:func:`latest_step`: whole, or a crashed run's slices), else
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
