"""Test-time latent-code optimization + evaluation (the ``optimize.py``
path), counterpart of ``codenerf_tpu/optimization/codes_opt.py``.

Reference protocol (``src/optimizer.py:18-240``): for each unseen object,
start the shape/texture codes at the mean of the trained embeddings, run
``num_opts`` AdamW steps on the codes only against the target view(s) —
model frozen — with the lr halved every ``lr_half_interval`` steps, then
score PSNR/SSIM on the remaining views.

Routes, chosen as the JAX package chooses them (``codes_route``):

- **single pass** (``use_fused_train`` and ``fused_composite``; coarse or
  with shared fine weights; chunks that split the rays exactly and that
  the single-pass kernel tiles): per ray chunk, the per-ray prologue
  (``ops/fused_mlp.prep_ray_operands``), then the fused loss kernel
  (``ops/fused_train.FusedCodesLoss``), whose cotangents flow back
  through the prologue into the codes. With hierarchical sampling the
  chunk runs as a training step does: the sigma-only coarse forward
  (``ops/fused_mlp.sigma_fwd``), the importance samples, and one
  dual-mode kernel call that optimizes ``se_fine + se_coarse``;
- **plane op** (``use_fused_train`` otherwise, when the plane ops tile
  the chunk; ``build_fused_codes_fns``): ``render_rays`` through the
  frozen-model plane op (``make_fused_codes_op``) and the PyTorch
  composite — separate fine weights, or ``fused_composite: false`` — or,
  coarse with ``fused_composite``, through the plane op chained into the
  standalone composite kernel (``make_fused_codes_composite_op``): the
  route of chunks that need padding (a 127×127 view is 4 × 4096 rays
  with 255 pad rays);
- **autodiff** (``use_fused_train`` off, e.g. ``srncar.json``, or the
  plane ops cannot tile the chunk): ``render_rays`` through the plain
  ``CodeNeRF``.

Pad rays (edge repeats) are masked out of the loss, and the loss scale is
``1 / (3 · real rays)``. The reported MSE is the fine pass's alone; the
code-norm regularizer adds its gradient; ``torch.optim.AdamW`` steps.
Each chunk's backward runs as soon as its loss exists, so memory is
bounded by a chunk (the JAX package rematerializes per chunk). An
occupancy grid (``occ_grid``, e.g. the category grid ``--opt_occ``
rebuilds) bounds the coarse depths of the optimization loop. Eval renders
through the plain ``CodeNeRF`` module(s), as the JAX package renders eval
through plain XLA, with ``eval_hp`` (the full sample budget) and without
the grid unless ``eval_occ``.

A step fits the full view, or with ``rays_per_step`` (``opt_rays``) a
minibatch drawn uniformly with replacement from the target rays, which
has no pad rays and so takes the single pass whether or not the view
chunks exactly (:func:`step_plan`). :func:`optimize_codes_batch` fits G
objects together under one AdamW, each chunk one object's rays, each
object its own generator, so row g follows object g's standalone run.

With a ``mesh`` (``parallel/mesh.py``) the object axis of batched fitting
and eval is split over the mesh's n batch shards, as in the JAX package
(``codes_opt.py:562-594``, ``:847-918``, ``:1158-1211``): padded to
``n·⌈G/n⌉`` objects by repeating the last one, rank i fits and scores
its contiguous block with each object's own generator and no collective
in the loop (a padded row takes a copy of the last object's generator),
and one ``all_gather`` a result gives every rank all G rows, each what
the unsharded run gives it. The caller's generators of the objects
another rank ran are not advanced.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from codenerf_tpu_torch import resolve_device
from codenerf_tpu_torch.config import Hparams, resolve_dtype
from codenerf_tpu_torch.core.rays import camera_rays
from codenerf_tpu_torch.core.render import composite_weights
from codenerf_tpu_torch.evaluation.metrics import (psnr, reference_psnr_mse,
                                                   ssim)
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.parallel.mesh import (all_gather_cat, batch_group,
                                              batch_shard)
from codenerf_tpu_torch.renderer import (chunk_plan, coarse_zvals, pad_rays,
                                         render_image, render_rays)
from codenerf_tpu_torch.training.schedules import step_halving


class OptimizationResult(NamedTuple):
    shape_code: torch.Tensor     # (D,)
    texture_code: torch.Tensor   # (D,)
    psnr_history: np.ndarray     # (num_opts,) target-view PSNR before each step
    progress: Optional[torch.Tensor] = None  # (num_opts, rays, 3) renders


def safe_code_norm(x: torch.Tensor) -> torch.Tensor:
    """``||x||`` with a finite gradient at 0 (reference reg,
    ``src/optimizer.py:213``)."""
    return torch.sqrt(torch.clamp(torch.sum(x * x), min=1e-24))


def _as_unit_float(images: np.ndarray) -> np.ndarray:
    if images.dtype == np.uint8:
        return images.astype(np.float32) / 255.0
    return np.asarray(images, dtype=np.float32)


def _flat_target_rays(images, poses, focal, view_idxs: Sequence[int],
                      H: int, W: int, device):
    """Origins, directions and gt pixels of the target views, stacked."""
    ros, vds, gts = [], [], []
    for v in view_idxs:
        ro, vd = camera_rays(H, W, focal, poses[v], device=device)
        ros.append(ro)
        vds.append(vd)
        gts.append(torch.from_numpy(
            _as_unit_float(images[v]).reshape(-1, 3)).to(device))
    return torch.cat(ros), torch.cat(vds), torch.cat(gts)


def build_fused_codes_fns(hp: Hparams, chunk: int, *,
                          use_fused: Optional[bool] = None,
                          input_grads: bool = False):
    """Counterpart of ``codes_opt.build_fused_codes_fns``: ``(apply_fn,
    composite_fn)`` for :func:`renderer.render_rays` on the frozen model's
    plane-op route, both None where plain autodiff runs. ``use_fused``
    None defers to ``hp.use_fused_train`` and falls back to autodiff
    quietly when the plane ops cannot tile the chunk; ``use_fused=True``
    raises ``ValueError`` there. ``input_grads`` selects the pose variant
    (the rays' and depths' cotangents kept), which never takes the
    composite op; the codes variant does, coarse with
    ``fused_composite``."""
    net_cfg, rcfg = hp.net, hp.render
    explicit = use_fused is True
    if use_fused is None:
        use_fused = hp.use_fused_train
    if not use_fused:
        return None, None
    counts = [rcfg.n_samples] + ([rcfg.n_samples + rcfg.n_importance]
                                 if rcfg.n_importance > 0 else [])
    if not all(fused_train.fused_train_available(net_cfg, chunk, n)
               for n in counts):
        if explicit:
            raise ValueError(
                "use_fused=True but the fused kernels can't tile this "
                f"problem (W={net_cfg.W}, chunk={chunk}, samples={counts})")
        return None, None
    if hp.fused_composite and rcfg.n_importance == 0 and not input_grads:
        op = fused_train.make_fused_codes_composite_op(
            net_cfg, white_bg=rcfg.white_bg)

        def composite_fn(m, cfg, ray_o, viewdir, z, s_code, t_code):
            return fused_train.fused_render_train(
                m, cfg, ray_o, viewdir, z, s_code, t_code, op=op,
                white_bg=rcfg.white_bg)

        return None, composite_fn
    op = (fused_train.make_fused_pose_op if input_grads
          else fused_train.make_fused_codes_op)(net_cfg)

    def apply_fn(m, cfg, ray_o, viewdir, z, s_code, t_code):
        return fused_train.fused_apply_train(m, cfg, ray_o, viewdir, z,
                                             s_code, t_code, op=op)

    return apply_fn, None


def _normalize_rays_per_step(rays_per_step, n_rays: int) -> Optional[int]:
    """The stochastic minibatch size, rounded up to the single-pass
    kernel's 16-ray tile (JAX ``codes_opt.py:177-197``), or None where the
    request covers the whole pool: the exact full-view protocol."""
    if rays_per_step is None:
        return None
    r = int(rays_per_step)
    if r <= 0:
        raise ValueError(f"rays_per_step must be positive, got {r}")
    r = -(-r // fused_train._TRAIN_TILE_RAYS) * fused_train._TRAIN_TILE_RAYS
    return None if r >= n_rays else r


def step_plan(n_rays: int, chunk: int,
              rays_per_step: Optional[int] = None) -> tuple:
    """``(chunk, n_chunks, n_step_rays)`` of one optimization step over a
    pool of ``n_rays`` target rays: the whole pool padded to
    :func:`renderer.chunk_plan`'s chunks, or, with a minibatch of
    ``rays_per_step`` rays (:func:`_normalize_rays_per_step`'s), that
    minibatch in chunks of at most the pool's chunk, ``n_chunks · chunk``
    rays drawn (JAX ``_build_run``, ``codes_opt.py:244-247``)."""
    chunk, n_chunks, n_padded = chunk_plan(n_rays, chunk)
    if rays_per_step is None:
        return chunk, n_chunks, n_padded
    chunk = min(int(rays_per_step), chunk)
    n_chunks = -(-int(rays_per_step) // chunk)
    return chunk, n_chunks, chunk * n_chunks


def codes_route(hp: Hparams, n_rays: int, chunk: int,
                use_fused: Optional[bool] = None,
                rays_per_step: Optional[int] = None) -> str:
    """The route of an optimization of ``n_rays`` target rays in chunks of
    ``chunk`` (:func:`step_plan`'s, with a minibatch of ``rays_per_step``
    rays a step where given): ``"single_pass"``, ``"plane_op"``
    (``apply_fn``), ``"plane_op_composite"`` (``composite_fn``) or
    ``"autodiff"`` — JAX ``codes_opt.py:250-268``. A minibatch has no pad
    rays, so it takes the single pass whether or not the pool chunks
    exactly. Raises where :func:`build_fused_codes_fns` does."""
    rcfg = hp.render
    rays_per_step = _normalize_rays_per_step(rays_per_step, n_rays)
    chunk, _, n_step = step_plan(n_rays, chunk, rays_per_step)
    want = hp.use_fused_train if use_fused is None else use_fused
    if (want and hp.fused_composite
            and (rcfg.n_importance == 0 or rcfg.share_fine_weights)
            and (rays_per_step is not None or n_step == n_rays)
            and fused_train.single_pass_available(hp.net, chunk)):
        return "single_pass"
    if not want:
        return "autodiff"
    apply_fn, composite_fn = build_fused_codes_fns(hp, chunk,
                                                   use_fused=use_fused)
    if composite_fn is not None:
        return "plane_op_composite"
    return "plane_op" if apply_fn is not None else "autodiff"


def _chunk_loss(model, hp: Hparams, trunk, ro, vd, gt, sc, tc, scale,
                generator, want_rgb: bool, occ_grid=None, z=None, u=None):
    """``(loss, fine, rgb8)`` of one ray chunk through the frozen-model
    kernel (:class:`ops.fused_train.FusedCodesLoss`) on the model's cached
    operands ``trunk`` (``fused_train.trunk_operands``); with
    hierarchical sampling the sigma-only coarse pass first and the dual
    mode. ``z`` and ``u`` replace the generator's draws (the tests feed
    both packages the same numbers)."""
    net_cfg, rcfg = hp.net, hp.render
    if z is None:
        z = coarse_zvals(rcfg, ro, vd, generator, occ_grid)
    ro8, vd8, z, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
        model, net_cfg, ro, vd, z, sc, tc)
    gt8 = fused_mlp.pad_lanes(gt.float(), 8)
    cmask = cdelta = None
    if rcfg.n_importance > 0:
        R, S = z.shape
        with torch.no_grad():
            sigma_c = fused_mlp.sigma_fwd(net_cfg, S, R, ro8, vd8, z,
                                          sproj.detach(), tproj, vcontrib,
                                          trunk)
        z, cmask, cdelta = fused_train.hier_fine_zvals_meta(
            z, composite_weights(sigma_c, z), generator, rcfg.n_importance,
            u=u)
    return fused_train.FusedCodesLoss.apply(
        sproj, tproj, vcontrib, net_cfg, rcfg.white_bg, scale, ro8, vd8, z,
        gt8, trunk, want_rgb, cmask, cdelta)


def _render_chunk_loss(model, hp: Hparams, ro, vd, gt, mask, sc, tc, scale,
                       generator, occ_grid=None, fine_model=None,
                       apply_fn=None, composite_fn=None, z=None, u=None):
    """``(loss, fine, rgb)`` of one ray chunk through ``render_rays``: the
    loss ``scale · Σ mask · (se_fine [+ se_coarse])`` (differentiable),
    the reported ``scale · Σ mask · se_fine`` and the final rgb rows (no
    gradient). ``z`` and ``u`` replace the generator's draws."""
    res = render_rays(model, hp.render, ro, vd, sc, tc, generator,
                      compute_dtype=resolve_dtype(hp.compute_dtype),
                      occ_grid=occ_grid, z=z, u=u, fine_model=fine_model,
                      apply_fn=apply_fn, composite_fn=composite_fn)
    m = mask.float()[:, None]
    se = torch.sum(m * (res.final.rgb - gt) ** 2)
    fine = (se * scale).detach()
    if res.fine is not None:
        se = se + torch.sum(m * (res.coarse.rgb - gt) ** 2)
    return se * scale, fine, res.final.rgb.detach()


def _own_rows(G: int, mesh) -> range:
    """The rows of the object axis this rank runs: all G without a mesh;
    else its block of the axis padded to ``n·⌈G/n⌉``, where row r is
    object ``min(r, G - 1)`` (JAX ``codes_opt.py:874-879``)."""
    if mesh is None:
        return range(G)
    i, n = batch_shard(mesh)
    per = -(-G // n)
    return range(i * per, (i + 1) * per)


def _row_generators(generators: Sequence, rows: range) -> list:
    """Each row's generator: its object's, or for a padded row a copy of
    the last object's (the object itself may run on this rank too)."""
    G = len(generators)
    out = []
    for r in rows:
        g = generators[min(r, G - 1)]
        if r >= G and g is not None:
            copy = torch.Generator(device=g.device)
            copy.set_state(g.get_state())
            g = copy
        out.append(g)
    return out


def _gather_rows(x: torch.Tensor, G: int, mesh, dim: int = 0):
    """Every rank's rows of ``x`` along ``dim``, the padding dropped."""
    if mesh is None:
        return x
    return all_gather_cat(x, batch_group(mesh), dim).narrow(dim, 0, G)


class BatchedOptimizationResult(NamedTuple):
    shape_codes: torch.Tensor    # (G, D)
    texture_codes: torch.Tensor  # (G, D)
    psnr_history: np.ndarray     # (num_opts, G) per-object PSNR per step


def _fit(model, hp: Hparams, ray_o: torch.Tensor, viewdir: torch.Tensor,
         gt_rgb: torch.Tensor, init_shape: torch.Tensor,
         init_texture: torch.Tensor, generators: Sequence, num_opts: int,
         lr: float, lr_half_interval: int, chunk: int, progress_rays: int,
         occ_grid, fine_model, use_fused: Optional[bool],
         rays_per_step: Optional[int], pix: Optional[torch.Tensor]):
    """G objects' codes, (G, D) tables under one AdamW: the body of
    :func:`optimize_codes` (G = 1) and :func:`optimize_codes_batch`.

    Each chunk holds one object's rays and that object's code rows; each
    object draws its minibatch and depths from its own generator, in the
    order its standalone run draws them; the loss scale is per ray and
    the reg ``Σ_g (‖s_g‖ + ‖t_g‖)``. AdamW is elementwise, so row g follows
    object g's standalone run (JAX ``_build_run_batch``,
    ``codes_opt.py:557-827``). ``pix`` (G, num_opts, rays a step) replaces
    the minibatch draws. Returns ``(shape (G, D), texture (G, D), history
    (num_opts, G), progress rows or None)``."""
    rcfg = hp.render
    G, n_rays = ray_o.shape[:2]
    dev = ray_o.device
    rays_per_step = _normalize_rays_per_step(rays_per_step, n_rays)
    stochastic = rays_per_step is not None
    if stochastic and progress_rays:
        raise ValueError(
            "progress renders need the full-view rays every step; "
            "rays_per_step subsampling and progress_rays are mutually "
            "exclusive")
    if occ_grid is not None and rcfg.shared_jitter:
        raise ValueError("occ_grid requires per-ray sampling: shared_jitter "
                         "is one global [near, far] slab")
    route = codes_route(hp, n_rays, chunk, use_fused, rays_per_step)
    chunk, n_chunks, n_step = step_plan(n_rays, chunk, rays_per_step)
    # The loss scale is per ray of a step: the real rays of the full view,
    # or every drawn ray of a minibatch (JAX codes_opt.py:247, :311).
    scale = 1.0 / ((n_step if stochastic else n_rays) * 3.0)
    progress_rays = min(int(progress_rays), n_rays)
    want_rgb = progress_rays > 0
    if route == "single_pass":
        trunk = fused_train.trunk_operands(model, hp.net)
    else:
        apply_fn, composite_fn = build_fused_codes_fns(hp, chunk,
                                                       use_fused=use_fused)
    if stochastic:
        mask = torch.ones(n_step, dtype=torch.bool, device=dev)
    else:
        ray_o, viewdir, gt_rgb = (
            torch.stack([pad_rays(x[g], n_step) for g in range(G)])
            for x in (ray_o, viewdir, gt_rgb))
        mask = torch.arange(n_step, device=dev) < n_rays

    D_s, D_t = init_shape.shape[-1], init_texture.shape[-1]
    sc = init_shape.detach().float().expand(G, D_s).clone().requires_grad_()
    tc = init_texture.detach().float().expand(G, D_t).clone(
        ).requires_grad_()
    opt = torch.optim.AdamW([sc, tc], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=hp.weight_decay)
    lr_at = step_halving(lr, lr_half_interval)
    history, progress = [], []
    for step in range(num_opts):
        for group in opt.param_groups:
            group["lr"] = lr_at(step)
        opt.zero_grad(set_to_none=True)
        mse, rows = [], []
        for g in range(G):
            ro, vd, gt = ray_o[g], viewdir[g], gt_rgb[g]
            if stochastic:
                # Uniform with replacement from the real pool, before the
                # route runs (JAX codes_opt.py:441-448).
                idx = (pix[g, step].to(dev) if pix is not None else
                       torch.randint(0, n_rays, (n_step,), device=dev,
                                     generator=generators[g]))
                ro, vd, gt = ro[idx], vd[idx], gt[idx]
            mse_g = 0.0
            for c in range(n_chunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                if route == "single_pass":
                    loss_c, fine_c, rgb8 = _chunk_loss(
                        model, hp, trunk, ro[sl], vd[sl], gt[sl], sc[g],
                        tc[g], scale, generators[g], want_rgb, occ_grid)
                    rgb = rgb8[:, :3]
                else:
                    loss_c, fine_c, rgb = _render_chunk_loss(
                        model, hp, ro[sl], vd[sl], gt[sl], mask[sl], sc[g],
                        tc[g], scale, generators[g], occ_grid, fine_model,
                        apply_fn, composite_fn)
                # Each chunk's backward at once: memory is bounded by a
                # chunk.
                loss_c.backward()
                mse_g = mse_g + fine_c
                if want_rgb:
                    rows.append(rgb)
            mse.append(mse_g)
        reg = sum(safe_code_norm(sc[g]) + safe_code_norm(tc[g])
                  for g in range(G))
        (hp.loss_reg_coef * reg).backward()
        opt.step()
        history.append(psnr(torch.stack(mse)))
        if want_rgb:
            progress.append(torch.cat(rows)[:progress_rays])
    return (sc.detach(), tc.detach(), torch.stack(history).cpu().numpy(),
            torch.stack(progress) if want_rgb else None)


def optimize_codes(model, hp: Hparams, ray_o: torch.Tensor,
                   viewdir: torch.Tensor, gt_rgb: torch.Tensor,
                   init_shape: torch.Tensor, init_texture: torch.Tensor,
                   generator: Optional[torch.Generator],
                   num_opts: int = 200, lr: float = 1e-2,
                   lr_half_interval: int = 50, chunk: int = 4096,
                   progress_rays: int = 0, occ_grid=None, fine_model=None,
                   use_fused: Optional[bool] = None,
                   rays_per_step: Optional[int] = None,
                   pix: Optional[torch.Tensor] = None) -> OptimizationResult:
    """Optimize one object's codes against flat target rays (all on the
    model's device) on :func:`codes_route`'s route; ``fine_model`` is the
    separate fine network. The full view every step, or with
    ``rays_per_step`` a minibatch drawn uniformly with replacement from
    the target rays each step (``psnr_history`` is then the minibatch's;
    ``pix`` (num_opts, rays a step) replaces the draws). A minibatch and
    ``progress_rays`` exclude each other (``ValueError``)."""
    s, t, hist, prog = _fit(
        model, hp, ray_o[None], viewdir[None], gt_rgb[None], init_shape,
        init_texture, [generator], num_opts, lr, lr_half_interval, chunk,
        progress_rays, occ_grid, fine_model, use_fused, rays_per_step,
        None if pix is None else pix[None])
    return OptimizationResult(s[0], t[0], hist[:, 0], prog)


def optimize_codes_batch(model, hp: Hparams, ray_o: torch.Tensor,
                         viewdir: torch.Tensor, gt_rgb: torch.Tensor,
                         init_shape: torch.Tensor,
                         init_texture: torch.Tensor,
                         generators: Sequence[Optional[torch.Generator]],
                         num_opts: int = 200, lr: float = 1e-2,
                         lr_half_interval: int = 50, chunk: int = 4096,
                         occ_grid=None, fine_model=None,
                         use_fused: Optional[bool] = None,
                         rays_per_step: Optional[int] = None,
                         pix: Optional[torch.Tensor] = None,
                         mesh=None) -> BatchedOptimizationResult:
    """Optimize G objects' codes together (JAX ``optimize_codes_batch``,
    ``codes_opt.py:829-932``): ``ray_o``/``viewdir``/``gt_rgb`` (G, N, 3),
    the initial codes (D,) or (G, D), one generator per object. Row g
    follows :func:`optimize_codes` on object g alone with
    ``generators[g]``; ``pix`` (G, num_opts, rays a step) replaces the
    minibatch draws. No progress renders. ``mesh`` splits the objects
    over its batch shards (the module docstring); every rank returns all
    G rows."""
    G = ray_o.shape[0]
    rows = _own_rows(G, mesh)
    gens = _row_generators(list(generators), rows)
    if mesh is not None:
        objs = [min(r, G - 1) for r in rows]
        ray_o, viewdir, gt_rgb = ray_o[objs], viewdir[objs], gt_rgb[objs]
        if init_shape.dim() == 2:
            init_shape, init_texture = init_shape[objs], init_texture[objs]
        if pix is not None:
            pix = pix[objs]
    s, t, hist, _ = _fit(
        model, hp, ray_o, viewdir, gt_rgb, init_shape, init_texture, gens,
        num_opts, lr, lr_half_interval, chunk, 0, occ_grid, fine_model,
        use_fused, rays_per_step, pix)
    if mesh is not None:
        s, t = _gather_rows(s, G, mesh), _gather_rows(t, G, mesh)
        hist = _gather_rows(torch.from_numpy(hist).to(s.device), G, mesh,
                            dim=1).cpu().numpy()
    return BatchedOptimizationResult(s, t, hist)


class CodeOptimizer:
    """The reference ``Optimizer``'s protocol: per-object code
    optimization, then held-out-view evaluation. The model and the
    separate fine network (``fine_model``), if any, are frozen (their
    parameters stop requiring gradients) and moved to ``device``.

    ``occ_grid`` (an ``OccupancyGrid``) bounds the optimization loop's
    coarse depths. Eval renders with ``eval_hp`` (default ``hp``) and uses
    the grid only with ``eval_occ``: the optimize CLI optimizes with a
    reduced budget (``--opt_samples``) and the category grid
    (``--opt_occ``) but scores held-out views with the jsonfile's full
    budget and no grid, so metrics stay comparable.

    ``opt_rays`` fits each step on that many target rays drawn at random
    (None: the full view, the reference protocol); eval is unaffected.
    :meth:`optimize_objects` / :meth:`evaluate_objects` run G objects
    together, each row as :meth:`optimize_object` / :meth:`evaluate_object`
    would give it with that object's generator; with a ``mesh`` each rank
    runs its block of the G objects and returns all G rows (the module
    docstring). The one-object methods ignore the mesh: every rank runs
    the object."""

    def __init__(self, model, hp: Hparams, mean_shape: torch.Tensor,
                 mean_texture: torch.Tensor, chunk: int = 4096,
                 device="cuda", occ_grid=None,
                 eval_hp: Optional[Hparams] = None, eval_occ: bool = True,
                 fine_model=None, opt_rays: Optional[int] = None,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model.to(self.device).requires_grad_(False)
        self.fine_model = (None if fine_model is None else
                           fine_model.to(self.device).requires_grad_(False))
        self.hp = hp
        self.mean_shape = mean_shape.float().to(self.device)
        self.mean_texture = mean_texture.float().to(self.device)
        self.chunk = chunk
        self.occ_grid = occ_grid
        self.eval_hp = eval_hp or hp
        self.eval_occ = eval_occ
        self.opt_rays = opt_rays

    def optimize_object(self, images: np.ndarray, poses: np.ndarray,
                        focal: float, tgt_views: Sequence[int],
                        generator: Optional[torch.Generator],
                        num_opts: int = 200, lr: float = 1e-2,
                        lr_half_interval: int = 50,
                        progress_images: bool = False) -> OptimizationResult:
        """``progress_images=True`` also returns each step's render of the
        first target view as (num_opts, H, W, 3) in ``progress``; it needs
        the full view every step, so ``opt_rays`` refuses it."""
        if progress_images and self.opt_rays is not None:
            raise ValueError(
                "progress_images=True renders the full first target view "
                "every step, but this CodeOptimizer was built with "
                f"opt_rays={self.opt_rays} (stochastic ray minibatches). "
                "Pass opt_rays=None or progress_images=False.")
        H, W = images.shape[1:3]
        ro, vd, gt = _flat_target_rays(images, poses, focal, tgt_views, H, W,
                                       self.device)
        res = optimize_codes(
            self.model, self.hp, ro, vd, gt, self.mean_shape,
            self.mean_texture, generator, num_opts=num_opts, lr=lr,
            lr_half_interval=lr_half_interval, chunk=self.chunk,
            progress_rays=H * W if progress_images else 0,
            occ_grid=self.occ_grid, fine_model=self.fine_model,
            rays_per_step=self.opt_rays)
        if progress_images:
            res = res._replace(progress=res.progress.reshape(num_opts, H, W,
                                                             3))
        return res

    def optimize_objects(self, images: np.ndarray, poses: np.ndarray,
                         focals: np.ndarray, tgt_views: Sequence[int],
                         generators: Sequence[Optional[torch.Generator]],
                         num_opts: int = 200, lr: float = 1e-2,
                         lr_half_interval: int = 50
                         ) -> BatchedOptimizationResult:
        """G objects' codes under one AdamW (:func:`optimize_codes_batch`):
        ``images`` (G, V, H, W, 3), ``poses`` (G, V, 4, 4), ``focals``
        (G,), one generator per object. Row g is what
        :meth:`optimize_object` gives object g with ``generators[g]``."""
        H, W = images.shape[2:4]
        rays = [_flat_target_rays(images[g], poses[g], float(focals[g]),
                                  tgt_views, H, W, self.device)
                for g in range(len(generators))]
        ro, vd, gt = (torch.stack(x) for x in zip(*rays))
        return optimize_codes_batch(
            self.model, self.hp, ro, vd, gt, self.mean_shape,
            self.mean_texture, generators, num_opts=num_opts, lr=lr,
            lr_half_interval=lr_half_interval, chunk=self.chunk,
            occ_grid=self.occ_grid, fine_model=self.fine_model,
            rays_per_step=self.opt_rays, mesh=self.mesh)

    def evaluate_objects(self, images: Optional[np.ndarray],
                         poses: np.ndarray, focals: np.ndarray,
                         exclude_views: Sequence[int],
                         shape_codes: torch.Tensor,
                         texture_codes: torch.Tensor,
                         generators: Sequence[Optional[torch.Generator]],
                         return_images: bool = False,
                         deterministic: bool = False,
                         gt_params: Optional[Dict] = None
                         ) -> Dict[str, np.ndarray]:
        """:meth:`evaluate_object` over G objects, object g with its codes
        row and ``generators[g]``: ``psnr``/``ssim`` (G, V'), ``views``
        (V',) and with ``return_images`` ``images`` (G, V', H, W, 3).

        ``gt_params`` (synthetic scenes; JAX ``codes_opt.py:1214-1300``)
        renders each eval view's ground truth on the device instead of
        taking pixels, and ``images`` may be ``None``: a dict with
        ``geometry``, ``pattern`` and ``hw`` (H, W) plus the per-object
        leaves ``albedo`` (G, 3) and ``radius`` (G,) or ``boxes`` (G, B, 2,
        3) and ``yaw`` (G,), the fields ``data/synthetic.synthetic_scene``
        returns. The rendered truth is quantized as the stored images are
        (``make_gt_view_renderer``), so the metrics match the pixel path's
        but where f32 and f64 round a pixel to different levels."""
        G = len(generators)
        rows = _own_rows(G, self.mesh)
        own = list(zip([min(r, G - 1) for r in rows],
                       _row_generators(list(generators), rows)))
        if gt_params is None:
            return self._gather(self._stack([self.evaluate_object(
                images[g], poses[g], float(focals[g]), exclude_views,
                shape_codes[g], texture_codes[g], gen,
                return_images=return_images, deterministic=deterministic)
                for g, gen in own], return_images), G)
        from codenerf_tpu_torch.data.synthetic import make_gt_view_renderer

        geometry = gt_params["geometry"]
        names = ("albedo",) + (("radius",) if geometry == "sphere"
                               else ("boxes", "yaw"))
        missing = [k for k in names if k not in gt_params]
        if missing:
            raise ValueError(f"gt_params for geometry {geometry!r} lacks "
                             f"{missing}")
        H, W = gt_params["hw"]
        gt_view = make_gt_view_renderer(H, W, bool(gt_params["pattern"]),
                                        geometry, self.device)
        leaves = {k: torch.from_numpy(np.asarray(gt_params[k], np.float32))
                  .to(self.device) for k in names}
        cams = torch.from_numpy(np.asarray(poses, np.float32)).to(self.device)
        fs = torch.from_numpy(np.asarray(focals, np.float32)).to(self.device)
        evs = []
        for g, gen in own:
            obj = {k: v[g] for k, v in leaves.items()}
            evs.append(self._evaluate(
                lambda v, g=g, obj=obj: gt_view(cams[g, v], fs[g], obj),
                poses[g], float(focals[g]), poses.shape[1], H, W,
                exclude_views, shape_codes[g], texture_codes[g], gen,
                return_images, deterministic))
        return self._gather(self._stack(evs, return_images), G)

    @staticmethod
    def _stack(evs, return_images: bool) -> Dict[str, np.ndarray]:
        out = {"views": evs[0]["views"]}
        for k in ("psnr", "ssim") + (("images",) if return_images else ()):
            out[k] = np.stack([ev[k] for ev in evs])
        return out

    def _gather(self, out: Dict[str, np.ndarray],
                G: int) -> Dict[str, np.ndarray]:
        """Under a mesh, every rank's rows of the metrics (and images)."""
        if self.mesh is None:
            return out
        for k in ("psnr", "ssim", "images"):
            if k in out:
                out[k] = _gather_rows(torch.from_numpy(out[k]).to(
                    self.device), G, self.mesh).cpu().numpy()
        return out

    def evaluate_object(self, images: np.ndarray, poses: np.ndarray,
                        focal: float, exclude_views: Sequence[int],
                        shape_code: torch.Tensor, texture_code: torch.Tensor,
                        generator: Optional[torch.Generator],
                        return_images: bool = False,
                        deterministic: bool = False) -> Dict[str, np.ndarray]:
        """PSNR/SSIM on every view not in ``exclude_views``, rendered with
        jittered z (the reference protocol) or, with ``deterministic``,
        linspace z."""
        def gt_of(v):
            gt = torch.from_numpy(np.asarray(images[v])).to(self.device)
            return gt.float() / 255.0 if gt.dtype == torch.uint8 \
                else gt.float()

        return self._evaluate(gt_of, poses, focal, images.shape[0],
                              *images.shape[1:3], exclude_views, shape_code,
                              texture_code, generator, return_images,
                              deterministic)

    @torch.no_grad()
    def _evaluate(self, gt_of, poses: np.ndarray, focal: float,
                  n_views: int, H: int, W: int,
                  exclude_views: Sequence[int], shape_code: torch.Tensor,
                  texture_code: torch.Tensor,
                  generator: Optional[torch.Generator], return_images: bool,
                  deterministic: bool) -> Dict[str, np.ndarray]:
        """The eval loop of one object; ``gt_of(v)`` is view v's ground
        truth, (H, W, 3) f32 on the device."""
        hp = self.eval_hp
        cd = resolve_dtype(hp.compute_dtype)
        excl = {int(i) for i in exclude_views}
        idxs = [v for v in range(n_views) if v not in excl]
        ps, ss, imgs = [], [], []
        for v in idxs:
            gt = gt_of(v)
            rgb = render_image(
                self.model, hp.render, H, W, focal, poses[v],
                shape_code, texture_code,
                None if deterministic else generator, chunk=self.chunk,
                compute_dtype=cd,
                occ_grid=self.occ_grid if self.eval_occ else None,
                fine_model=self.fine_model)
            ps.append(psnr(reference_psnr_mse(rgb, gt)))
            ss.append(ssim(rgb, gt))
            if return_images:
                imgs.append(rgb)
        out = {"views": np.asarray(idxs),
               "psnr": torch.stack(ps).cpu().numpy(),
               "ssim": torch.stack(ss).cpu().numpy()}
        if return_images:
            out["images"] = torch.stack(imgs).cpu().numpy()
        return out
