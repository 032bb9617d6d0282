"""The training step (counterpart of ``codenerf_tpu/training/train_step.py``).

One step = one globally-sampled ray batch (all objects, views and pixels
mixed): rays from ``pixel_rays``, coarse depths from the state's
generator, the loss and its gradients, one AdamW update.

Loss (reference ``src/trainer.py:75-83``): the MSE of the composited RGB
plus ``(loss_reg_coef / reg_chunk_divisor) · mean(‖z_s‖ + ‖z_t‖)`` on the
batch's gathered codes. Two routes compute its gradients:

- **fused** (``use_fused_train``, the flagship): the per-ray prologue
  (code gather, latent projections, ``flatten_params``, the reg term) in
  PyTorch, then ``ops/fused_train.FusedTrainLoss`` — the single-pass
  kernel in ``weight_grads=True`` mode — and one ``backward()`` that
  chains the kernel's cotangents and dW/db through the prologue, as the
  JAX package's one ``jax.vjp`` does;
- **autodiff** (configs without ``use_fused_train``, e.g. the root CLI's
  ``srncar.json``): the plain ``CodeNeRF.forward`` and ``composite``, then
  ``backward()``.

Optimizer (reference ``src/trainer.py:117-131``): AdamW (betas 0.9/0.999,
eps 1e-8, ``weight_decay``) with the model on ``lr_schedule[0]`` and both
code tables on ``[1]``, each step-halved; with
``quirks.optimizer_reset_every`` the window-frozen schedule and a reset of
the Adam moments at each window start.

``microbatch_rays`` splits the batch into equal microbatches, each a
separate forward/backward whose gradients accumulate (averaged): memory is
bounded by the microbatch. The z jitter is drawn for the whole batch first,
so the result does not depend on the split. The metrics are the mean over
microbatches, with PSNR recomputed from the mean MSE.

Hierarchical sampling, the training occupancy grid, the plane-op kernels
(``fused_composite=false``) and a device mesh raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from codenerf_tpu_torch.config import Hparams, resolve_dtype
from codenerf_tpu_torch.core.rays import pixel_rays
from codenerf_tpu_torch.core.render import composite
from codenerf_tpu_torch.evaluation.metrics import psnr
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.renderer import check_render_config, coarse_zvals
from codenerf_tpu_torch.training.schedules import (step_halving,
                                                   window_frozen_step_halving)
from codenerf_tpu_torch.training.state import TrainState

Batch = Dict[str, torch.Tensor]


def expand_compact_batch(batch: Batch, tables: Batch) -> Batch:
    """The compact index batch (obj i32, view i32, uv i16, rgb u8 — see
    ``RayBatchPipeline.sample(compact=True)``) in the per-ray layout the
    loss takes, with pose and focal gathered from the device-resident
    ``tables``. ``rgb / 255.0`` is the host-side conversion, bit for bit."""
    obj = batch["obj"].long()
    return {
        "obj": obj,
        "uv": batch["uv"].float(),
        "c2w": tables["c2w"][obj, batch["view"].long()],
        "focal": tables["focal"][obj],
        "rgb": batch["rgb"].float() / 255.0,
    }


def lr_schedules(hp: Hparams):
    """(model schedule, codes schedule), each a function of the step."""
    window = hp.quirks.optimizer_reset_every
    if window > 0:
        return tuple(window_frozen_step_halving(s.lr, s.interval, window)
                     for s in (hp.lr_model, hp.lr_codes))
    return tuple(step_halving(s.lr, s.interval)
                 for s in (hp.lr_model, hp.lr_codes))


def build_optimizer(hp: Hparams, model, shape_codes,
                    texture_codes) -> torch.optim.AdamW:
    """AdamW with two groups: the model (group 0) and both code tables
    (group 1). The step sets each group's lr from :func:`lr_schedules`."""
    return torch.optim.AdamW(
        [{"params": list(model.parameters()), "lr": hp.lr_model.lr},
         {"params": [shape_codes, texture_codes], "lr": hp.lr_codes.lr}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=hp.weight_decay)


def _check_supported(hp: Hparams, mesh) -> None:
    check_render_config(hp.render)
    if hp.train_occupancy is not None:
        raise NotImplementedError(
            "train_occupancy (training-time occupancy grid) is not ported "
            "yet (ROADMAP.md Queue 1, item 8)")
    if hp.use_fused_train and not hp.fused_composite:
        raise NotImplementedError(
            "fused_composite=false (the plane-op kernels) is not ported yet "
            "(ROADMAP.md Queue 2, items 3 and 6)")
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (multi-GPU training) is not ported yet "
            "(ROADMAP.md Queue 1, item 12)")


def build_grad_fn(hp: Hparams, H: int, W: int, microbatch_rays: int = 0,
                  batch_size: int = 0, mesh=None):
    """Returns ``grad_fn(state, batch[, z]) -> metrics``: the gradients of
    the batch loss (expanded layout), averaged over the microbatches,
    accumulated into the state's ``.grad`` s, and the step's ``loss``,
    ``mse``, ``psnr`` and ``reg`` as 0-dim tensors on the state's device
    (reading them synchronizes). ``z`` (R, S) replaces the generator's
    draw — the tests feed both packages the same depths."""
    _check_supported(hp, mesh)
    net_cfg, rcfg = hp.net, hp.render
    compute_dtype = resolve_dtype(hp.compute_dtype)
    reg_coef = hp.loss_reg_coef / hp.quirks.reg_chunk_divisor
    step_rays = microbatch_rays or batch_size
    if hp.use_fused_train and step_rays and not \
            fused_train.single_pass_available(net_cfg, step_rays):
        raise ValueError(
            "use_fused_train requires W % 256 == 0, num_xyz_freq <= 10, "
            ">= 1 shape/texture block and a ray count divisible by "
            f"{fused_train._TRAIN_TILE_RAYS} (got W={net_cfg.W}, "
            f"d_xyz={net_cfg.d_xyz}, blocks={net_cfg.shape_blocks}/"
            f"{net_cfg.texture_blocks}, rays/step={step_rays})")

    def loss_fn(state: TrainState, obj, ray_o, viewdir, z, rgb):
        """(loss, mse, reg) of one (micro)batch, differentiable."""
        model = state.model
        # index_select's backward is index_add_; indexing's sort-based
        # backward serialises over the repeated rows (every ray of an
        # object hits the same row) and took ~5 ms per 16,384-ray step.
        sc = state.shape_codes.index_select(0, obj)
        tc = state.texture_codes.index_select(0, obj)
        if hp.use_fused_train:
            ro8, vd8, z, sproj, tproj, vcontrib = \
                fused_mlp.prep_ray_operands(model, net_cfg, ray_o, viewdir,
                                            z, sc, tc)
            wflat = fused_train.flatten_params(model, net_cfg)
            static = (net_cfg, rcfg.white_bg, 1.0 / (rgb.shape[0] * 3.0),
                      ro8, vd8, z, fused_mlp.pad_lanes(rgb.float(), 8))
            mse = fused_train.FusedTrainLoss.apply(static, sproj, tproj,
                                                   vcontrib, *wflat)
        else:
            xyz = ray_o[:, None, :] + viewdir[:, None, :] * z[..., None]
            sig, rgbs = model(xyz, viewdir, sc, tc,
                              compute_dtype=compute_dtype)
            res = composite(sig, rgbs, z, white_bg=rcfg.white_bg)
            mse = torch.mean((res.rgb - rgb) ** 2)
        reg = torch.mean(torch.linalg.norm(sc, dim=-1)
                         + torch.linalg.norm(tc, dim=-1))
        return mse + reg_coef * reg, mse, reg

    def grad_fn(state: TrainState, batch: Batch,
                z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        ray_o, viewdir = pixel_rays(batch["uv"], batch["focal"],
                                    batch["c2w"], H, W)
        if z is None:
            z = coarse_zvals(rcfg, ray_o, state.generator)
        B = batch["rgb"].shape[0]
        mb = microbatch_rays or B
        if B % mb:
            raise ValueError(f"batch {B} not divisible by microbatch {mb}")
        k = B // mb
        sums = torch.zeros(3, device=z.device)
        for i in range(k):
            sl = slice(i * mb, (i + 1) * mb)
            loss, mse, reg = loss_fn(state, batch["obj"][sl], ray_o[sl],
                                     viewdir[sl], z[sl], batch["rgb"][sl])
            (loss / k).backward()
            sums += torch.stack([loss, mse, reg]).detach()
        loss, mse, reg = sums / k
        return {"loss": loss, "mse": mse, "psnr": psnr(mse), "reg": reg}

    return grad_fn


def apply_update(state: TrainState, hp: Hparams) -> None:
    """One AdamW update from the gradients in ``.grad`` at the state's
    step (each group's lr from :func:`lr_schedules`; with
    ``quirks.optimizer_reset_every``, fresh Adam moments at each window
    start — the reference's quirk 3), then clear the gradients and count
    the step."""
    opt = state.optimizer
    window = hp.quirks.optimizer_reset_every
    if window > 0 and state.step % window == 0:
        opt.state.clear()
    for group, sched in zip(opt.param_groups, lr_schedules(hp)):
        group["lr"] = sched(state.step)
    opt.step()
    opt.zero_grad(set_to_none=True)
    state.step += 1


def build_train_step(hp: Hparams, H: int, W: int,
                     microbatch_rays: int = 0, batch_size: int = 0,
                     mesh=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``train_step(state, batch, tables) -> metrics``: one
    :func:`build_grad_fn` pass on the compact ``batch`` expanded with the
    pipeline's device-resident ``tables``, and one :func:`apply_update`,
    updating ``state`` in place (model, codes, moments, generator,
    step)."""
    grad_fn = build_grad_fn(hp, H, W, microbatch_rays, batch_size, mesh)

    def train_step(state: TrainState, batch: Batch,
                   tables: Batch) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        metrics = grad_fn(state, expand_compact_batch(batch, tables))
        apply_update(state, hp)
        return metrics

    return train_step
