"""Joint camera-pose + latent-code optimization (counterpart of
``codenerf_tpu/optimization/pose_opt.py``).

Given one image of an unseen object whose camera pose is unknown or
wrong, refine an se(3) twist ``xi`` (``core/poses.py``, ``c2w = exp(xi) @
init_c2w``) together with the shape and texture codes by gradient descent
through ray generation and volume rendering (CodeNeRF §4.3). Each step
draws ``rays_per_step`` pixels, derives their rays from the current pose,
and renders them at fresh coarse depths.

Routes, chosen as the JAX package chooses them:

- **single pass** (``use_fused_train`` and ``fused_composite``; coarse or
  hierarchical with shared fine weights): one call of the kernel's pose
  mode (``ops/fused_train.FusedPoseLoss``: the loss and the exact
  ``d_ro8``, ``d_vd8``, ``d_z`` and code cotangents) on the coarse depths,
  with the compositing weights when hierarchical; then ``hier_fine_zvals``
  on those (detached) weights and a second call on the union. Autograd
  chains both calls through ``prep_ray_operands``, ``coarse_zvals`` (the
  sphere bounds), ``pixel_rays`` and ``refine_pose`` — the JAX package's
  explicit ``vjp`` s. The fine call's depth cotangent reaches the coarse
  depths only through the union sort: the importance samples are
  constants (``sample_pdf`` detaches, as JAX's stops the gradient);
- **plane op** (``use_fused_train`` otherwise — ``fused_composite:
  false`` or separate fine weights — when the plane ops tile the ray
  count): the loss through ``render_rays`` with ``apply_fn`` the
  frozen-model plane op in its pose mode (``make_fused_pose_op``, from
  ``codes_opt.build_fused_codes_fns(input_grads=True)``): the kernel's
  ray and depth cotangents, and the composite's depth cotangent through
  PyTorch autograd; the fine pass through ``fine_model``;
- **autodiff** (``use_fused_train`` off, e.g. ``srncar.json``, or a ray
  count the plane ops cannot tile): the loss through the plain
  ``CodeNeRF`` and ``render_rays``, as JAX runs plain XLA there.

Optimizer: Adam on ``xi`` and AdamW on the codes (``weight_decay``), each
with a step-halving lr. The first ``pose_only_steps`` steps leave the codes
where they are while their Adam moments keep accumulating: the JAX package
zeroes the codes' update (weight decay included) after ``optax`` has
updated their state, which stepping the codes and restoring them
reproduces. Pose optimization uses no occupancy grid. The PSNR history
stays on the device until the end (one host read per call).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from codenerf_tpu_torch.config import Hparams, resolve_dtype
from codenerf_tpu_torch.core.poses import refine_pose
from codenerf_tpu_torch.core.rays import pixel_rays
from codenerf_tpu_torch.evaluation.metrics import psnr
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.optimization.codes_opt import (build_fused_codes_fns,
                                                      safe_code_norm)
from codenerf_tpu_torch.renderer import coarse_zvals, render_rays
from codenerf_tpu_torch.training.schedules import step_halving


class PoseOptimizationResult(NamedTuple):
    c2w: torch.Tensor            # (4, 4) refined pose
    xi: torch.Tensor             # (6,) twist applied
    shape_code: torch.Tensor     # (D,)
    texture_code: torch.Tensor   # (D,)
    psnr_history: np.ndarray     # (num_opts,)


class PoseState(NamedTuple):
    """The optimized variables (leaf tensors) and their optimizers."""
    xi: torch.Tensor
    shape: torch.Tensor
    texture: torch.Tensor
    opt_pose: torch.optim.Adam
    opt_codes: torch.optim.AdamW
    lr_pose: Callable[[int], float]
    lr_codes: Callable[[int], float]


def pose_route(hp: Hparams, rays_per_step: int,
               use_fused: Optional[bool] = None) -> str:
    """``"single_pass"``, ``"plane_op"`` or ``"autodiff"``, as JAX
    ``pose_opt.py:89-98`` chooses: the single pass where it applies, else
    ``build_fused_codes_fns(input_grads=True)`` — which falls back to
    autodiff quietly when ``use_fused`` is None and raises ``ValueError``
    when it is True."""
    fused = hp.use_fused_train if use_fused is None else use_fused
    if fused and hp.fused_composite and (
            hp.render.n_importance == 0 or hp.render.share_fine_weights) \
            and fused_train.single_pass_available(hp.net, rays_per_step):
        return "single_pass"
    apply_fn, _ = build_fused_codes_fns(hp, rays_per_step,
                                        use_fused=use_fused,
                                        input_grads=True)
    return "autodiff" if apply_fn is None else "plane_op"


def make_pose_state(hp: Hparams, init_shape: torch.Tensor,
                    init_texture: torch.Tensor, lr_codes: float = 1e-2,
                    lr_pose: float = 1e-2,
                    lr_half_interval: int = 50) -> PoseState:
    """``xi = 0`` and the initial codes on the codes' device, with Adam on
    the pose and AdamW on the codes."""
    dev = init_shape.device
    xi = torch.zeros(6, dtype=torch.float32, device=dev, requires_grad=True)
    sc = init_shape.detach().float().clone().requires_grad_(True)
    tc = init_texture.detach().float().clone().requires_grad_(True)
    adam = dict(betas=(0.9, 0.999), eps=1e-8)
    return PoseState(
        xi, sc, tc, torch.optim.Adam([xi], lr=lr_pose, **adam),
        torch.optim.AdamW([sc, tc], lr=lr_codes,
                          weight_decay=hp.weight_decay, **adam),
        step_halving(lr_pose, lr_half_interval),
        step_halving(lr_codes, lr_half_interval))


def build_pose_loss(model, hp: Hparams, image: torch.Tensor,
                    init_c2w: torch.Tensor, focal: float,
                    rays_per_step: int = 2048, optimize_codes: bool = True,
                    use_fused: Optional[bool] = None, fine_model=None):
    """Returns ``loss_fn(xi, shape, texture, generator, pix=None,
    jitter=None, u=None) -> (loss, mse)`` for one step on ``image`` (H, W,
    3) float [0, 1] on the model's device: the pixel indices ``pix``
    (rays_per_step,), the coarse ``jitter`` (rays_per_step, N_samples) and
    the importance probes ``u`` (rays_per_step, N_importance) come from
    ``generator`` unless given (the tests feed both packages the same
    numbers). ``loss`` is differentiable; ``mse`` (the fine pass's under
    hierarchical sampling) is detached. The model (and ``fine_model``,
    the separate fine network) is frozen."""
    net_cfg, rcfg = hp.net, hp.render
    H, W = image.shape[0], image.shape[1]
    R = min(rays_per_step, H * W)
    route = pose_route(hp, R, use_fused)
    dev = image.device
    flat_rgb = image.reshape(-1, 3).float()
    init_c2w = init_c2w.float()
    focal_b = torch.full((R,), float(focal), dtype=torch.float32, device=dev)
    hier = rcfg.n_importance > 0
    scale = 1.0 / (R * 3.0)
    compute_dtype = resolve_dtype(hp.compute_dtype)
    trunk = (fused_train.trunk_operands(model, net_cfg)
             if route == "single_pass" else None)
    apply_fn = (build_fused_codes_fns(hp, R, use_fused=use_fused,
                                      input_grads=True)[0]
                if route == "plane_op" else None)

    def rays(xi, generator, pix):
        if pix is None:
            pix = torch.randint(0, H * W, (R,), generator=generator,
                                device=dev)
        uv = torch.stack([(pix % W).float(),
                          torch.div(pix, W, rounding_mode="floor").float()],
                         dim=-1)
        c2w = refine_pose(xi, init_c2w)
        ro, vd = pixel_rays(uv, focal_b, c2w[:3, :].expand(R, 3, 4), H, W)
        return ro, vd, flat_rgb[pix]

    def single_pass(ro, vd, gt, sc, tc, generator, jitter, u):
        z = coarse_zvals(rcfg, ro, vd, generator, jitter=jitter)
        ops = fused_mlp.prep_ray_operands(model, net_cfg, ro, vd, z, sc, tc)
        ro8, vd8, z, sproj, tproj, vcontrib = ops
        static = (net_cfg, rcfg.white_bg, scale, fused_mlp.pad_lanes(gt, 8),
                  trunk)
        loss, mse, w = fused_train.FusedPoseLoss.apply(*ops, *static, hier)
        if hier:
            z_all = fused_train.hier_fine_zvals(z, w, generator,
                                                rcfg.n_importance, u=u)
            loss_f, mse, _ = fused_train.FusedPoseLoss.apply(
                ro8, vd8, z_all, sproj, tproj, vcontrib, *static, False)
            loss = loss + loss_f
        return loss, mse

    def autodiff(ro, vd, gt, sc, tc, generator, jitter, u):
        res = render_rays(model, rcfg, ro, vd, sc, tc, generator,
                          compute_dtype=compute_dtype, u=u, jitter=jitter,
                          fine_model=fine_model, apply_fn=apply_fn)
        mse = torch.mean((res.final.rgb - gt) ** 2)
        loss = mse
        if res.fine is not None:
            loss = loss + torch.mean((res.coarse.rgb - gt) ** 2)
        return loss, mse.detach()

    render = single_pass if route == "single_pass" else autodiff

    def loss_fn(xi, shape, texture, generator, pix=None, jitter=None,
                u=None):
        if not optimize_codes:
            shape, texture = shape.detach(), texture.detach()
        ro, vd, gt = rays(xi, generator, pix)
        loss, mse = render(ro, vd, gt, shape, texture, generator, jitter, u)
        reg = safe_code_norm(shape) + safe_code_norm(texture)
        return loss + hp.loss_reg_coef * reg, mse

    return loss_fn


def apply_pose_update(state: PoseState, step: int,
                      pose_only_steps: int = 0) -> None:
    """One update from the gradients in ``.grad`` at 0-based ``step``: Adam
    on ``xi``, AdamW on the codes; before ``pose_only_steps`` the codes are
    put back after their step (their moments advance, they do not move).
    A code without a gradient (``optimize_codes=False``) steps on a zero
    gradient, as the JAX package's stopped gradient gives it."""
    for opt, lr in ((state.opt_pose, state.lr_pose),
                    (state.opt_codes, state.lr_codes)):
        for group in opt.param_groups:
            group["lr"] = lr(step)
    state.opt_pose.step()
    for p in (state.shape, state.texture):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    frozen = step < pose_only_steps
    if frozen:
        kept = [p.detach().clone() for p in (state.shape, state.texture)]
    state.opt_codes.step()
    if frozen:
        with torch.no_grad():
            state.shape.copy_(kept[0])
            state.texture.copy_(kept[1])


def pose_step(loss_fn, state: PoseState, step: int, pose_only_steps: int,
              generator: Optional[torch.Generator], pix=None, jitter=None,
              u=None) -> torch.Tensor:
    """One optimization step; returns the step's (pre-update) MSE, on the
    device."""
    state.opt_pose.zero_grad(set_to_none=True)
    state.opt_codes.zero_grad(set_to_none=True)
    loss, mse = loss_fn(state.xi, state.shape, state.texture, generator,
                        pix=pix, jitter=jitter, u=u)
    loss.backward()
    apply_pose_update(state, step, pose_only_steps)
    return mse


def optimize_pose_and_codes(model, hp: Hparams, image: torch.Tensor,
                            init_c2w: torch.Tensor, focal: float,
                            init_shape: torch.Tensor,
                            init_texture: torch.Tensor,
                            generator: Optional[torch.Generator],
                            num_opts: int = 200, lr_codes: float = 1e-2,
                            lr_pose: float = 1e-2,
                            lr_half_interval: int = 50,
                            rays_per_step: int = 2048,
                            optimize_codes: bool = True,
                            pose_only_steps: int = 0,
                            use_fused: Optional[bool] = None,
                            fine_model=None) -> PoseOptimizationResult:
    """Jointly refine (pose, codes) against one target ``image`` (H, W, 3)
    float [0, 1], with ``init_c2w`` (4, 4), the codes and the model all on
    one device. ``optimize_codes=False`` freezes the codes (registration
    only); ``pose_only_steps`` freezes them for the first steps (the
    pose/code ambiguity: free codes can absorb a pose error). The draws
    come from ``generator``; ``fine_model`` is the separate fine
    network."""
    model.requires_grad_(False)
    if fine_model is not None:
        fine_model.requires_grad_(False)
    loss_fn = build_pose_loss(model, hp, image, init_c2w, focal,
                              rays_per_step, optimize_codes, use_fused,
                              fine_model)
    state = make_pose_state(hp, init_shape, init_texture, lr_codes, lr_pose,
                            lr_half_interval)
    history = [psnr(pose_step(loss_fn, state, step, pose_only_steps,
                              generator))
               for step in range(num_opts)]
    xi = state.xi.detach()
    return PoseOptimizationResult(
        c2w=refine_pose(xi, init_c2w.float()), xi=xi,
        shape_code=state.shape.detach(), texture_code=state.texture.detach(),
        psnr_history=torch.stack(history).cpu().numpy())
