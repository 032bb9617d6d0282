"""The training step (counterpart of ``codenerf_tpu/training/train_step.py``).

One step = one globally-sampled ray batch (all objects, views and pixels
mixed): rays from ``pixel_rays``, coarse depths from the state's
generator, the loss and its gradients, one AdamW update.

Loss (reference ``src/trainer.py:75-83``): the MSE of the composited RGB
plus ``(loss_reg_coef / reg_chunk_divisor) · mean(‖z_s‖ + ‖z_t‖)`` on the
batch's gathered codes. Every route gathers the codes with
``ops/code_rows.gather_code_rows``, whose backward sums the rays' rows
into the tables' gradients in one fixed order (on the card
``code_rows.cu``, where ``index_select``'s ``index_add_`` adds with
atomics), so a training repeats bit for bit. Three routes compute the
gradients:

- **fused** (``use_fused_train``, the flagship): the per-ray prologue
  (code gather, latent projections, ``flatten_params``, the reg term) in
  PyTorch, then ``ops/fused_train.FusedTrainLoss`` — the single-pass
  kernel in ``weight_grads=True`` mode — and one ``backward()`` that
  chains the kernel's cotangents and dW/db through the prologue, as the
  JAX package's one ``jax.vjp`` does;
- **plane op** (``use_fused_train`` without the single-pass loss:
  ``fused_composite: false``, or hierarchical sampling with separate fine
  weights): ``render_rays`` with ``apply_fn`` the plane op in its
  training mode (``ops/fused_train.make_fused_train_op(input_grads=
  False)``: the four-plane forward, and a backward that recomputes it and
  returns the codes' and every weight's cotangents from the planes'),
  the composite in PyTorch autograd, then ``backward()``; the coarse and
  the fine pass each run it, on their own network;
- **autodiff** (configs without ``use_fused_train``, e.g. the root CLI's
  ``srncar.json``): the plain ``CodeNeRF.forward`` and ``composite``, then
  ``backward()``.

Optimizer (reference ``src/trainer.py:117-131``): AdamW (betas 0.9/0.999,
eps 1e-8, ``weight_decay``) with the model on ``lr_schedule[0]`` and both
code tables on ``[1]``, each step-halved; with
``quirks.optimizer_reset_every`` the window-frozen schedule and a reset of
the Adam moments at each window start.

Hierarchical sampling (``N_importance > 0``) adds the coarse MSE to the
loss, as standard NeRF does; ``mse`` (and PSNR) stay the fine pass's.
With separate fine weights (``hierarchical_share_weights: false``) the
fine pass runs the state's ``fine_model`` at the union of the coarse and
fine depths, and AdamW's model group holds both networks. On the fused
route the coarse pass is forward-only — the
sigma-only kernel (``ops/fused_mlp.sigma_fwd``), ``composite_weights``,
``hier_fine_zvals_meta`` — and one dual-mode kernel call at the union of
the coarse and fine depths computes both losses, its cotangents already
summed, so one ``backward()`` through the prologue gives the gradient of
``fine_mse + coarse_mse + reg``. On the autodiff route ``render_rays``
runs both passes. Coarse depths lie between per-ray bounds from the
bounding sphere (``bound_sphere_radius``) and the training occupancy grid
(``occ_grid``, the trainer's).

``microbatch_rays`` splits the batch into equal microbatches, each a
separate forward/backward whose gradients accumulate (averaged): memory is
bounded by the microbatch. The z jitter and the importance probes are
drawn for the whole batch first, so the result does not depend on the
split. The metrics are the mean over microbatches, with PSNR recomputed
from the mean MSE.

Data parallelism (``mesh``, ``parallel/mesh.py``): each of the mesh's n
batch shards takes its rows of the step's batch (``B/n`` rays, and
``microbatch_rays/n`` a microbatch, the count every ray-count rule
checks) and runs the route as above on them; the depths and importance
probes are drawn for the whole batch from the state's generator, which
stays the same on every rank, and sliced. After the last microbatch one
all-reduce averages every gradient (both networks and both code tables)
and the step's loss, MSE and reg over the shards, and AdamW then updates
the same weights the same way on every rank. Each shard's loss is the
mean over its own rays, so with equal shards the mean of the shard means
is the whole batch's mean: the JAX package's global scale and ``psum``
(its ``train_step.py:322``, ``:379-384``) by another route. PSNR comes
from the averaged MSE. Without a mesh no collective runs. The reduction
is not ``DistributedDataParallel``: the single-pass kernel returns every
dW/db at the end of one ``autograd.Function``, so overlapping the
reduction with the backward gains nothing, and the state holds a model,
a fine network and two code tables, not one module.

A ``model`` axis above 1 (tensor parallelism, ``parallel/mesh.py``) is
the autodiff route's alone, as in JAX: the fused routes refuse it with
JAX's ``ValueError``. Each (micro)batch's forward gathers the whole
networks and tables from the ranks' slices (``state.whole_trainables``),
the backward leaves each rank its slices' gradients; after the last
microbatch the replicated layers' gradients and the metrics are the
``model`` group's first rank's, and the batch axes' all-reduce and AdamW
then act on the slices.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from codenerf_tpu_torch.config import Hparams, resolve_dtype
from codenerf_tpu_torch.core.rays import pixel_rays
from codenerf_tpu_torch.core.render import composite, composite_weights
from codenerf_tpu_torch.core.sampling import fine_uniforms, uniform01_u8
from codenerf_tpu_torch.evaluation.metrics import psnr
from codenerf_tpu_torch.ops import code_rows, fused_mlp, fused_train
from codenerf_tpu_torch.parallel.mesh import (all_reduce_mean_, batch_group,
                                              batch_shard, model_size)
from codenerf_tpu_torch.renderer import coarse_zvals, render_rays
from codenerf_tpu_torch.training.schedules import (step_halving,
                                                   window_frozen_step_halving)
from codenerf_tpu_torch.training.state import (TrainState, named_trainables,
                                               whole_trainables)
from codenerf_tpu_torch.utils.tracing import span

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


def build_optimizer(hp: Hparams, model, shape_codes, texture_codes,
                    fine_model=None) -> torch.optim.AdamW:
    """AdamW with two groups: the model and the fine network, if any
    (group 0), and both code tables (group 1). The step sets each group's
    lr from :func:`lr_schedules`."""
    nets = list(model.parameters()) + (
        [] if fine_model is None else list(fine_model.parameters()))
    return torch.optim.AdamW(
        [{"params": nets, "lr": hp.lr_model.lr},
         {"params": [shape_codes, texture_codes], "lr": hp.lr_codes.lr}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=hp.weight_decay)


def uses_single_pass_loss(hp: Hparams) -> bool:
    """The single-pass loss kernel's route: ``use_fused_train`` with
    ``fused_composite``, coarse or with shared fine weights (JAX
    ``train_step.py:286``). The other ``use_fused_train`` configs take
    the plane op."""
    return hp.use_fused_train and hp.fused_composite and (
        hp.render.n_importance == 0 or hp.render.share_fine_weights)


def _check_supported(hp: Hparams) -> None:
    if hp.train_occupancy is not None:
        if hp.render.shared_jitter:
            raise ValueError(
                "train_occupancy requires per-ray sampling: shared_jitter is "
                "one global jitter vector and cannot carry per-ray bounds")
        if hp.train_occupancy.radius is None \
                and hp.render.bound_sphere_radius is None:
            raise ValueError(
                "train_occupancy needs a grid extent: set "
                "train_occupancy.radius or bound_sphere_radius")


def build_grad_fn(hp: Hparams, H: int, W: int, microbatch_rays: int = 0,
                  batch_size: int = 0, mesh=None):
    """Returns ``grad_fn(state, batch, z=None, u=None, occ_grid=None) ->
    metrics``: the gradients of the batch loss (expanded layout), averaged
    over the microbatches, accumulated into the state's ``.grad`` s, and
    the step's ``loss``, ``mse``, ``psnr`` and ``reg`` as 0-dim tensors on
    the state's device (reading them synchronizes). ``z`` (R, S) and, with
    hierarchical sampling, ``u`` (R, N_importance) replace the generator's
    draws — the tests feed both packages the same numbers. ``occ_grid``
    bounds the coarse depths (an ``OccupancyGrid``).

    With a ``mesh``, ``batch`` holds this rank's rows of the step's batch
    (``RayBatchPipeline.sample(shard=batch_shard(mesh))``), ``z`` and
    ``u`` the whole batch's, and the gradients and metrics are the
    averages over the batch shards. A ``model`` axis above 1 takes the
    autodiff route only: a fused config raises JAX's ``ValueError``."""
    _check_supported(hp)
    if hp.use_fused_train and model_size(mesh) > 1:
        raise ValueError(
            "use_fused_train requires replicated weights: the fused "
            "kernels hold full weight matrices in VMEM, so a 'model' "
            "(tensor-parallel) axis > 1 is unsupported. Use data/replica "
            "parallelism or disable the flag.")
    net_cfg, rcfg = hp.net, hp.render
    compute_dtype = resolve_dtype(hp.compute_dtype)
    reg_coef = hp.loss_reg_coef / hp.quirks.reg_chunk_divisor
    hier = rcfg.n_importance > 0
    single_pass = uses_single_pass_loss(hp)
    shard, n_shards, group = 0, 1, None
    if mesh is not None:
        shard, n_shards = batch_shard(mesh)
        group = batch_group(mesh)
    # Every fused route checks the plane-op pair's rule for every sample
    # count it evaluates at this rank's rays, as the JAX step does (its
    # build_train_step; 32 * 16 rays when the batch is not known).
    step_rays = (microbatch_rays or batch_size
                 or 32 * fused_train._TRAIN_TILE_RAYS)
    if step_rays % n_shards:
        raise ValueError(f"batch {step_rays} not divisible by the "
                         f"{n_shards}-way batch sharding")
    step_rays //= n_shards
    counts = [rcfg.n_samples] + ([rcfg.n_samples + rcfg.n_importance]
                                 if hier else [])
    ok = all(fused_train.fused_train_available(net_cfg, step_rays, n)
             for n in counts)
    if hp.use_fused_train and not ok:
        raise ValueError(
            "use_fused_train requires W % 256 == 0, num_xyz_freq <= 10, "
            ">= 1 shape/texture block and a ray count divisible by "
            f"{fused_mlp._TILE_RAYS} (got W={net_cfg.W}, d_xyz="
            f"{net_cfg.d_xyz}, blocks="
            f"{net_cfg.shape_blocks}/{net_cfg.texture_blocks}, rays/step="
            f"{step_rays})")
    apply_fn = None
    if hp.use_fused_train and not single_pass:
        plane_op = fused_train.make_fused_train_op(net_cfg,
                                                   input_grads=False)

        def apply_fn(m, cfg, ray_o, viewdir, z, s_code, t_code):
            return fused_train.fused_apply_train(m, cfg, ray_o, viewdir, z,
                                                 s_code, t_code, op=plane_op)

    def fused_loss(model, ray_o, viewdir, z, u, rgb, sc, tc):
        """(loss, mse) from the single-pass kernel; with hierarchical
        sampling the sigma-only coarse pass first, then the dual mode."""
        ro8, vd8, z, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
            model, net_cfg, ray_o, viewdir, z, sc, tc)
        # wflat carries dW/db back to the model; the kernels read the
        # step's cached operands (one packing per step, shared by the
        # microbatches and the sigma pass).
        wflat = fused_train.flatten_params(model, net_cfg)
        trunk = fused_train.trunk_operands(model, net_cfg)
        gt8 = fused_mlp.pad_lanes(rgb.float(), 8)
        static = (net_cfg, rcfg.white_bg, 1.0 / (rgb.shape[0] * 3.0),
                  ro8, vd8, z, gt8, None, None, trunk)
        if hier:
            # Forward-only coarse pass: the importance weights need sigma
            # and z alone, and the coarse loss rides the union call.
            R, S = z.shape
            with torch.no_grad():
                sigma_c = fused_mlp.sigma_fwd(
                    net_cfg, S, R, ro8, vd8, z, sproj.detach(), tproj,
                    vcontrib, trunk)
            z_all, cmask, cdelta = fused_train.hier_fine_zvals_meta(
                z, composite_weights(sigma_c, z), None, rcfg.n_importance,
                u=u)
            static = static[:5] + (z_all, gt8, cmask, cdelta, trunk)
        return fused_train.FusedTrainLoss.apply(static, sproj, tproj,
                                                vcontrib, *wflat)

    def loss_fn(state: TrainState, obj, ray_o, viewdir, z, u, rgb):
        """(loss, mse, reg) of one (micro)batch, differentiable; ``mse``
        is the fine pass's under hierarchical sampling."""
        model, fine, shape_codes, texture_codes = whole_trainables(state)
        with span("step.codes"):
            # The tables' gradients sum the rays' rows in one fixed order
            # (ops/code_rows.py), so a training repeats bit for bit.
            order = code_rows.RowOrder.of(obj, shape_codes.shape[0])
            sc = code_rows.gather_code_rows(shape_codes, obj, order)
            tc = code_rows.gather_code_rows(texture_codes, obj, order)
        with span("step.forward"):
            if single_pass:
                loss, mse = fused_loss(model, ray_o, viewdir, z, u, rgb, sc,
                                       tc)
            elif hier or apply_fn is not None:
                res = render_rays(model, rcfg, ray_o, viewdir, sc, tc, None,
                                  compute_dtype=compute_dtype, z=z, u=u,
                                  fine_model=fine,
                                  apply_fn=apply_fn)
                mse = torch.mean((res.final.rgb - rgb) ** 2)
                loss = mse
                if res.fine is not None:
                    loss = loss + torch.mean((res.coarse.rgb - rgb) ** 2)
            else:
                xyz = ray_o[:, None, :] + viewdir[:, None, :] * z[..., None]
                sig, rgbs = model(xyz, viewdir, sc, tc,
                                  compute_dtype=compute_dtype)
                res = composite(sig, rgbs, z, white_bg=rcfg.white_bg)
                loss = mse = torch.mean((res.rgb - rgb) ** 2)
            reg = torch.mean(torch.linalg.norm(sc, dim=-1)
                             + torch.linalg.norm(tc, dim=-1))
            return loss + reg_coef * reg, mse.detach(), reg

    def rays(state: TrainState, batch: Batch, z, u, occ_grid):
        """The rays of this rank's rows, and the whole batch's coarse
        depths (and importance probes) drawn and cut to those rows."""
        ray_o, viewdir = pixel_rays(batch["uv"], batch["focal"],
                                    batch["c2w"], H, W)
        B = batch["rgb"].shape[0]
        # This rank's rows of the whole batch's draws.
        rows = slice(shard * B, (shard + 1) * B)
        dev = ray_o.device
        if z is None:
            jitter = None
            if n_shards > 1 and not rcfg.shared_jitter:
                jitter = uniform01_u8(state.generator, B * n_shards,
                                      rcfg.n_samples, dev)[rows]
            z = coarse_zvals(rcfg, ray_o, viewdir, state.generator, occ_grid,
                             jitter=jitter)
        elif n_shards > 1:
            z = z[rows]
        if hier:
            if u is None:
                u = fine_uniforms(state.generator, B * n_shards,
                                  rcfg.n_importance, dev)
            if n_shards > 1:
                u = u[rows]
        return ray_o, viewdir, z, u

    def grad_fn(state: TrainState, batch: Batch,
                z: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                occ_grid=None) -> Dict[str, torch.Tensor]:
        with span("step.rays"):
            ray_o, viewdir, z, u = rays(state, batch, z, u, occ_grid)
        B = batch["rgb"].shape[0]
        dev = ray_o.device
        mb = microbatch_rays // n_shards or B
        if B % mb:
            raise ValueError(f"batch {B} not divisible by microbatch {mb}")
        k = B // mb
        sums = torch.zeros(3, device=dev)
        for i in range(k):
            sl = slice(i * mb, (i + 1) * mb)
            loss, mse, reg = loss_fn(state, batch["obj"][sl], ray_o[sl],
                                     viewdir[sl], z[sl],
                                     u[sl] if hier else None,
                                     batch["rgb"][sl])
            with span("step.backward"):
                (loss / k).backward()
            sums += torch.stack([loss, mse, reg]).detach()
        sums /= k
        if state.shards is not None or group is not None:
            with span("step.reduce"):
                if state.shards is not None:
                    # One copy of what the model axis replicates (mesh.py).
                    state.shards.share_([
                        p.grad for n, p in named_trainables(state).items()
                        if state.shards.dims[n] is None
                        and p.grad is not None] + [sums])
                if group is not None:
                    all_reduce_mean_([p.grad for p in trainable_params(state)
                                      if p.grad is not None] + [sums], group)
        loss, mse, reg = sums
        return {"loss": loss, "mse": mse, "psnr": psnr(mse), "reg": reg}

    return grad_fn


def trainable_params(state: TrainState):
    """Every parameter AdamW updates, in its groups' order."""
    return [p for group in state.optimizer.param_groups
            for p in group["params"]]


def apply_update(state: TrainState, hp: Hparams) -> None:
    """One AdamW update from the gradients in ``.grad`` at the state's
    step (each group's lr from :func:`lr_schedules`; with
    ``quirks.optimizer_reset_every``, fresh Adam moments at each window
    start — the reference's quirk 3), then clear the gradients, drop the
    networks' cached kernel operands (``fused_train.trunk_operands``:
    a fused AdamW step leaves the parameters' versions as they were) and
    count the step."""
    opt = state.optimizer
    window = hp.quirks.optimizer_reset_every
    if window > 0 and state.step % window == 0:
        opt.state.clear()
    for group, sched in zip(opt.param_groups, lr_schedules(hp)):
        group["lr"] = sched(state.step)
    opt.step()
    opt.zero_grad(set_to_none=True)
    for net in (state.model, state.fine_model):
        if net is not None:
            fused_train.drop_trunk_operands(net)
    state.step += 1


def build_train_step(hp: Hparams, H: int, W: int,
                     microbatch_rays: int = 0, batch_size: int = 0,
                     mesh=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``train_step(state, batch, tables, occ_grid=None) ->
    metrics``: one :func:`build_grad_fn` pass on the compact ``batch``
    expanded with the pipeline's device-resident ``tables`` (coarse depths
    bounded by ``occ_grid`` when given), and one :func:`apply_update`,
    updating ``state`` in place (model, codes, moments, generator,
    step).

    ``train_step.counters`` counts, always, the ``steps`` and the host
    seconds spent inside the calls (``host_s``: issuing each step's work,
    and any wait inside it). While a profiler records, each call is the
    span ``train.step`` over its phases ``step.rays``, ``step.codes``,
    ``step.forward``, ``step.backward``, ``step.reduce`` (with a mesh)
    and ``step.update``."""
    grad_fn = build_grad_fn(hp, H, W, microbatch_rays, batch_size, mesh)

    def train_step(state: TrainState, batch: Batch, tables: Batch,
                   occ_grid=None) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        with span("train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            metrics = grad_fn(state, expand_compact_batch(batch, tables),
                              occ_grid=occ_grid)
            with span("step.update"):
                apply_update(state, hp)
        c = train_step.counters
        c["steps"] += 1
        c["host_s"] += time.perf_counter() - t0
        return metrics

    train_step.counters = {"steps": 0, "host_s": 0.0}
    return train_step
