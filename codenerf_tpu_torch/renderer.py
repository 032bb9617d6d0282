"""Ray and image rendering (counterpart of ``codenerf_tpu/renderer.py``).

Coarse pass: stratified z-values between per-ray bounds — the global
``[near, far]`` slab, tightened to the bounding sphere
(``bound_sphere_radius``) and to an occupancy grid's occupied span — then
the MLP and the composite. Fine pass (``n_importance > 0``):
inverse-CDF samples from the coarse weights. With shared weights and the
plain module only the new samples go through the MLP, and their sigma and
rgb planes are merged with the coarse pass's by ``merge_sorted_samples``
and composited again (the JAX package's ``reuse_coarse`` recipe);
otherwise the fine pass evaluates the union of the coarse and fine depths
explicitly, through the fine network (``fine_model``) when the weights
are not shared.

``apply_fn`` swaps the plain ``CodeNeRF`` for another evaluation of
sigma and rgb planes (the plane-op kernels, ``ops/fused_train.
fused_apply_train``) under the PyTorch composite; ``composite_fn`` for
one that composites too (``fused_render_train``), coarse only.

Eval (:func:`render_image`) takes one of two routes, chosen by
:func:`kernel_route` from the call's own inputs. On the card, in bf16,
at the sizes the kernels take, every chunk goes through the port's
forward kernels (:func:`render_rays_kernels`, one launch of each a group
of whole chunks up to :data:`KERNEL_RAYS` rays): for a coarse render the
four-plane forward ``fused_mlp.planes_fwd`` and the composite kernel;
for a hierarchical one (NeRF's coarse-to-fine sampling, shared or
separate fine weights) first the sigma-only forward
``fused_mlp.sigma_fwd`` at the coarse depths, the compositing weights
and the inverse-CDF resample in PyTorch, then the fine network's
four-plane forward and the composite at the sorted union. Every other
call, the CPU's included, renders through the plain module(s), as the
JAX package renders eval through plain XLA. ``render_image.chunks``
counts the chunks of each route, ``render_image.samples`` the points the
kernels evaluated. :func:`render_image` is :func:`finish_image` of
:func:`prepare_image`: the first stage enqueues everything before the
first forward launch (on the card, for a deterministic render on the
kernel route, as one CUDA graph) and the second only launches, so that
a server can prepare one request while the device runs another's.
"""

from __future__ import annotations

import threading
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from codenerf_tpu_torch.config import RenderConfig
from codenerf_tpu_torch.core.rays import camera_rays, ray_sphere_bounds
from codenerf_tpu_torch.core.render import (RenderOutput, composite,
                                            composite_weights)
from codenerf_tpu_torch.core.sampling import (fine_uniforms, fixed_zvals,
                                              lerp_linspace,
                                              merge_sorted_samples,
                                              sample_pdf, stratified_zvals,
                                              union_sorted_zvals)
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.ops.composite import composite_fwd
from codenerf_tpu_torch.utils.tracing import span


class RenderResult(NamedTuple):
    coarse: RenderOutput
    fine: Optional[RenderOutput]

    @property
    def final(self) -> RenderOutput:
        """The output to train against and display: fine if present."""
        return self.fine if self.fine is not None else self.coarse


def chunk_plan(n_rays: int, target: int = 4096) -> tuple:
    """``(chunk, n_chunks, n_padded)``: an exact divisor of ``n_rays``
    >= target/2 when one exists, else a 128-multiple chunk with padding."""
    if n_rays <= target:
        return n_rays, 1, n_rays
    for c in range(target, target // 2 - 1, -1):
        if n_rays % c == 0:
            return c, n_rays // c, n_rays
    n_chunks = -(-n_rays // target)
    per_chunk = -(-n_rays // n_chunks)
    chunk = min(target, ((per_chunk + 127) // 128) * 128)
    n_chunks = -(-n_rays // chunk)
    return chunk, n_chunks, n_chunks * chunk


def pad_rays(x: torch.Tensor, n_padded: int) -> torch.Tensor:
    """Pad the leading axis to ``n_padded`` by repeating the last row."""
    n = x.shape[0]
    if n == n_padded:
        return x
    return torch.cat([x, x[-1:].expand(n_padded - n, *x.shape[1:])], dim=0)


def coarse_zvals(rcfg: RenderConfig, ray_o: torch.Tensor,
                 viewdir: torch.Tensor,
                 generator: Optional[torch.Generator],
                 occ_grid=None,
                 jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse depth samples (R, n_samples). Per-ray bounds tighten
    ``[near, far]`` to the bounding sphere and/or the occupancy grid
    (never under the reference's shared jitter, one global slab by
    definition). Linspace between the bounds when ``generator`` and
    ``jitter`` are None (deterministic), else stratified with per-ray (or
    the reference's shared) jitter drawn from ``generator`` or given as
    ``jitter`` (the tests feed both packages the same numbers).
    Differentiable with respect to the rays through the bounds."""
    R, dev = ray_o.shape[0], ray_o.device
    use_bounds = (rcfg.bound_sphere_radius is not None
                  or occ_grid is not None) and not rcfg.shared_jitter
    if use_bounds:
        if rcfg.bound_sphere_radius is not None:
            t0, t1 = ray_sphere_bounds(ray_o, viewdir, rcfg.near, rcfg.far,
                                       rcfg.bound_sphere_radius)
        else:
            t0 = torch.full((R,), rcfg.near, dtype=torch.float32, device=dev)
            t1 = torch.full((R,), rcfg.far, dtype=torch.float32, device=dev)
        if occ_grid is not None:
            from codenerf_tpu_torch.core.occupancy import ray_grid_bounds

            t0, t1 = ray_grid_bounds(occ_grid, ray_o, viewdir, t0, t1,
                                     n_probes=rcfg.occ_probes)
    if generator is None and jitter is None:
        if use_bounds:
            t = lerp_linspace(0.0, 1.0, rcfg.n_samples, device=dev)
            return t0[:, None] + t[None, :] * (t1 - t0)[:, None]
        z = fixed_zvals(rcfg.near, rcfg.far, rcfg.n_samples, device=dev)
        return z.expand(R, rcfg.n_samples)
    if use_bounds:
        return stratified_zvals(generator, t0, t1, rcfg.n_samples,
                                num_rays=R, jitter=jitter, device=dev)
    z = stratified_zvals(generator, rcfg.near, rcfg.far, rcfg.n_samples,
                         num_rays=R, shared=rcfg.shared_jitter, jitter=jitter,
                         device=dev)
    return z.expand(R, rcfg.n_samples)


def fine_zvals(rcfg: RenderConfig, z: torch.Tensor, weights: torch.Tensor,
               generator: Optional[torch.Generator],
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fine pass's ``n_importance`` depths (R, n_importance): inverse-CDF
    samples of the piecewise-constant pdf of the interior coarse
    ``weights`` over the midpoints of the coarse depths ``z`` (R, S).
    Probes evenly spaced when ``generator`` and ``u`` are None, else ``u``
    or the generator's uniforms (``core/sampling.sample_pdf``)."""
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    return sample_pdf(z_mid, weights[:, 1:-1], rcfg.n_importance, generator,
                      deterministic=generator is None and u is None, u=u)


def _eval_raw(model, ray_o, viewdir, z, shape_code, texture_code,
              compute_dtype) -> Tuple[torch.Tensor, tuple]:
    """Per-sample sigmas (R, S) and the three rgb planes at ``z``."""
    xyz = ray_o[:, None, :] + viewdir[:, None, :] * z[..., None]
    sigmas, rgbs = model(xyz, viewdir, shape_code, texture_code,
                         compute_dtype=compute_dtype)
    return sigmas, (rgbs[..., 0], rgbs[..., 1], rgbs[..., 2])


def render_rays(model, rcfg: RenderConfig, ray_o: torch.Tensor,
                viewdir: torch.Tensor, shape_code: torch.Tensor,
                texture_code: torch.Tensor,
                generator: Optional[torch.Generator],
                compute_dtype: torch.dtype = torch.bfloat16,
                occ_grid=None, z: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                jitter: Optional[torch.Tensor] = None, fine_model=None,
                apply_fn=None, composite_fn=None) -> RenderResult:
    """Render a batch of rays: the coarse pass and, with ``n_importance >
    0``, the fine pass. ``generator`` None renders deterministically
    (linspace z, evenly spaced CDF probes). ``z`` (R, n_samples), or the
    coarse ``jitter`` of :func:`coarse_zvals`, and ``u`` (R, n_importance)
    replace the generator's draws — the tests feed both packages the same
    numbers.

    ``fine_model``: the fine network when ``rcfg.share_fine_weights`` is
    False (ignored otherwise). ``apply_fn(model, cfg, ray_o, viewdir, z,
    shape_code, texture_code) -> (sigmas (R, S), rgbs)`` (rgbs (R, S, 3)
    or three (R, S) planes) replaces the plain module's evaluation;
    ``composite_fn``, of the same signature, returns a finished
    ``RenderOutput`` whose ``weights`` may be None, so it excludes
    ``n_importance > 0`` (a ``ValueError``)."""
    if composite_fn is not None and rcfg.n_importance > 0:
        raise ValueError(
            "composite_fn (the fused composite) does not emit the weights "
            "plane hierarchical sampling needs; use apply_fn with "
            "n_importance > 0")
    if z is None:
        z = coarse_zvals(rcfg, ray_o, viewdir, generator, occ_grid,
                         jitter=jitter)

    def eval_and_composite(m, zz):
        if composite_fn is not None:
            return composite_fn(m, m.cfg, ray_o, viewdir, zz, shape_code,
                                texture_code)
        if apply_fn is not None:
            sig, rgbs = apply_fn(m, m.cfg, ray_o, viewdir, zz, shape_code,
                                 texture_code)
        else:
            sig, rgbs = _eval_raw(m, ray_o, viewdir, zz, shape_code,
                                  texture_code, compute_dtype)
        return composite(sig, rgbs, zz, white_bg=rcfg.white_bg)

    # With shared weights on the plain module the fine pass evaluates only
    # the new samples: the coarse ones' values are the same network at the
    # same z, so they are cached and merged into union order. The other
    # evaluations evaluate the union explicitly.
    reuse_coarse = (rcfg.n_importance > 0 and apply_fn is None
                    and composite_fn is None
                    and (rcfg.share_fine_weights or fine_model is None))
    if reuse_coarse:
        sig_c, rgb_c = _eval_raw(model, ray_o, viewdir, z, shape_code,
                                 texture_code, compute_dtype)
        coarse = composite(sig_c, rgb_c, z, white_bg=rcfg.white_bg)
    else:
        coarse = eval_and_composite(model, z)
    if rcfg.n_importance <= 0:
        return RenderResult(coarse=coarse, fine=None)
    z_fine = fine_zvals(rcfg, z, coarse.weights, generator, u)
    if reuse_coarse:
        sig_f, rgb_f = _eval_raw(model, ray_o, viewdir, z_fine, shape_code,
                                 texture_code, compute_dtype)
        z_all, merged = merge_sorted_samples(z, z_fine, (sig_c,) + rgb_c,
                                             (sig_f,) + rgb_f)
        fine = composite(merged[0], merged[1:], z_all,
                         white_bg=rcfg.white_bg)
        return RenderResult(coarse=coarse, fine=fine)
    fine = eval_and_composite(fine_network(model, rcfg, fine_model),
                              union_sorted_zvals(z, z_fine))
    return RenderResult(coarse=coarse, fine=fine)


def fine_network(model, rcfg: RenderConfig, fine_model=None):
    """The network of the render's last pass: ``fine_model`` on a
    hierarchical render whose weights are not shared, when one is given;
    else ``model``."""
    if rcfg.n_importance > 0 and not rcfg.share_fine_weights:
        return model if fine_model is None else fine_model
    return model


def kernel_route(model, rcfg: RenderConfig, chunk: int,
                 compute_dtype: torch.dtype, device,
                 fine_model=None) -> bool:
    """Whether :func:`render_image` evaluates its chunks of ``chunk`` rays
    through the forward kernels (:func:`render_rays_kernels`): on CUDA,
    in bf16 (the precision the kernels compute in), for a ``CodeNeRF``
    whose width and sample counts the kernels take
    (``fused_mlp.fused_available`` and ``fused_train.
    single_pass_available``): the coarse count and, with ``n_importance >
    0``, the union of coarse and fine depths each at most
    ``fused_train._MAX_SAMPLES``, and a fine network that is ``model``
    (shared weights or none given) or a ``CodeNeRF`` of the same widths.
    Otherwise the plain module."""
    if not (torch.device(device).type == "cuda"
            and compute_dtype == torch.bfloat16
            and isinstance(model, CodeNeRF)):
        return False
    cfg = model.cfg
    counts = [rcfg.n_samples]
    if rcfg.n_importance > 0:
        fine = fine_network(model, rcfg, fine_model)
        if fine is not model and not (isinstance(fine, CodeNeRF)
                                      and fine.cfg == cfg):
            return False
        counts.append(rcfg.n_samples + rcfg.n_importance)
    return (cfg.W == fused_train.TRUNK_W
            and fused_train.single_pass_available(cfg, chunk)
            and all(S <= fused_train._MAX_SAMPLES
                    and fused_mlp.fused_available(cfg, chunk, S)
                    for S in counts))


# The chunks render_image rendered on each route, and the points the
# forward kernels evaluated (render_image.chunks and .samples, which
# RenderServer.timings() reports): counted here, so that a wrapper put in
# render_image's place leaves the counts working.
ROUTE_CHUNKS = {"kernels": 0, "plain": 0}
KERNEL_SAMPLES = {"coarse_sigma": 0, "planes": 0}

# Rays one launch of render_rays_kernels covers (whole chunks, at least
# one): a 128 x 128 view in one launch, so a render pays the wrappers'
# host work once, and device memory bounded by it, not by the image (the
# four-plane forward's workspace, 1.5 x rays x samples x W bf16: 1.2 GB
# at 96 samples, 2.4 GB at a 64 + 128 union).
KERNEL_RAYS = 16384


def _draws(rcfg: RenderConfig, ray_o: torch.Tensor, viewdir: torch.Tensor,
           generator: Optional[torch.Generator], occ_grid, chunk: int):
    """The coarse depths (R, n_samples) and, for a random hierarchical
    render, the fine pass's probes (R, n_importance) of rays (R, 3), drawn
    chunk by chunk in the order :func:`render_rays` draws them on the
    plain route (a chunk's depths, then its probes); probes None when
    deterministic or coarse."""
    zs, us = [], []
    for i in range(0, ray_o.shape[0], chunk):
        ro, vd = ray_o[i:i + chunk], viewdir[i:i + chunk]
        zs.append(coarse_zvals(rcfg, ro, vd, generator, occ_grid))
        if rcfg.n_importance > 0 and generator is not None:
            us.append(fine_uniforms(generator, ro.shape[0],
                                    rcfg.n_importance, ro.device))
    return torch.cat(zs), (torch.cat(us) if us else None)


class _Group(NamedTuple):
    """One launch group's operands: its rays' count, the coarse depths,
    a random hierarchical render's fine probes (else None) and the rays'
    operands (``fused_mlp.ray_operands``)."""
    n: int
    z: torch.Tensor
    u: Optional[torch.Tensor]
    ro8: torch.Tensor
    vd8: torch.Tensor
    vcontrib: torch.Tensor


class PreparedImage(NamedTuple):
    """A render :func:`prepare_image` began: the call's inputs (``chunk``
    as :func:`chunk_plan` gives it), its camera rays padded to whole
    chunks, whether the forward kernels take it, and on the kernel route
    the networks' operands and the first launch group's. The operands are
    the four-plane network's trunk operands and code projections (copied
    to a launch's rows), and a separate coarse network's (None when one
    network does both passes)."""
    model: torch.nn.Module
    rcfg: RenderConfig
    H: int
    W: int
    shape_code: torch.Tensor
    texture_code: torch.Tensor
    generator: Optional[torch.Generator]
    chunk: int
    compute_dtype: torch.dtype
    occ_grid: object
    fine_model: Optional[torch.nn.Module]
    kernels: bool
    ray_o: Optional[torch.Tensor] = None
    viewdir: Optional[torch.Tensor] = None
    trunk: Optional[fused_mlp.TrunkOperands] = None
    sproj: Optional[torch.Tensor] = None
    tproj: Optional[torch.Tensor] = None
    trunk_c: Optional[fused_mlp.TrunkOperands] = None
    sproj_c: Optional[torch.Tensor] = None
    first: Optional[_Group] = None


def _group_rays(chunk: int) -> int:
    return chunk * max(1, KERNEL_RAYS // chunk)


def _with_trunks(p: PreparedImage) -> PreparedImage:
    """``p`` with its networks' trunk operands (``fused_train.
    trunk_operands``, packed once per weight version): the coarse
    network's only where it has code projections of its own."""
    cfg, net = p.model.cfg, fine_network(p.model, p.rcfg, p.fine_model)
    return p._replace(trunk=fused_train.trunk_operands(net, cfg),
                      trunk_c=(None if p.sproj_c is None else
                               fused_train.trunk_operands(p.model, cfg)))


def _kernels_prepare(p: PreparedImage) -> PreparedImage:
    """Everything of a render on the kernel route before its first
    forward launch: the networks' operands and the first launch group's
    (:func:`_group_operands`)."""
    cfg, net = p.model.cfg, fine_network(p.model, p.rcfg, p.fine_model)
    codes = p.shape_code.reshape(1, -1), p.texture_code.reshape(1, -1)
    rows = min(_group_rays(p.chunk), p.ray_o.shape[0])

    def per_row(x):
        return x.expand(rows, -1, -1).contiguous()

    with span("render.operands"):
        sproj, tproj = map(per_row, fused_mlp.code_operands(net, cfg, *codes))
        sproj_c = (None if net is p.model else per_row(
            fused_mlp.code_operands(p.model, cfg, *codes)[0]))
        p = _with_trunks(p._replace(sproj=sproj, tproj=tproj,
                                    sproj_c=sproj_c))
    return p._replace(first=_group_operands(p, 0))


def _group_operands(p: PreparedImage, start: int) -> _Group:
    """The operands of the launch group of rays from ``start``: the
    depths and probes (:func:`_draws`) and the rays' operands."""
    end = start + _group_rays(p.chunk)
    with span("render.operands"):
        ro, vd = p.ray_o[start:end], p.viewdir[start:end]
        z, u = _draws(p.rcfg, ro, vd, p.generator, p.occ_grid, p.chunk)
        ro8, vd8, vcontrib = fused_mlp.ray_operands(
            fine_network(p.model, p.rcfg, p.fine_model), p.model.cfg, ro, vd)
    return _Group(ro.shape[0], z, u, ro8, vd8, vcontrib)


def _render_group(p: PreparedImage, g: _Group) -> torch.Tensor:
    """The final rgb (n, 3) of one launch group: on a hierarchical render
    the sigma-only forward, the weights and the resample, then the
    four-plane forward and the composite."""
    cfg, rcfg, z = p.model.cfg, p.rcfg, g.z
    if rcfg.n_importance > 0:
        own = p.sproj_c is not None             # a separate coarse network
        with span("render.coarse"):
            sig = fused_mlp.sigma_fwd(
                cfg, z.shape[1], g.n, g.ro8, g.vd8, z,
                (p.sproj_c if own else p.sproj)[:g.n], None, None,
                p.trunk_c if own else p.trunk)
            weights = composite_weights(sig, z)
        with span("render.resample"):
            z = union_sorted_zvals(z, fine_zvals(rcfg, z, weights,
                                                 p.generator, g.u))
        KERNEL_SAMPLES["coarse_sigma"] += g.n * rcfg.n_samples
    with span("render.chunk"):
        sig, r, gr, b = fused_mlp.planes_fwd(
            cfg, z.shape[1], g.n, g.ro8, g.vd8, z, p.sproj[:g.n],
            p.tproj[:g.n], g.vcontrib, p.trunk)
        rgb = composite_fwd(sig, r, gr, b, z, rcfg.white_bg)[:, :3]
    KERNEL_SAMPLES["planes"] += g.n * z.shape[1]
    return rgb


def _kernels_finish(p: PreparedImage) -> torch.Tensor:
    """The launches of a render :func:`_kernels_prepare` prepared: the
    first group's, then each later group's operands and launches."""
    group = _group_rays(p.chunk)
    parts = [_render_group(p, p.first)]
    for start in range(group, p.ray_o.shape[0], group):
        parts.append(_render_group(p, _group_operands(p, start)))
    return torch.cat(parts)


@torch.no_grad()
def render_rays_kernels(model, rcfg: RenderConfig, ray_o: torch.Tensor,
                        viewdir: torch.Tensor, shape_code: torch.Tensor,
                        texture_code: torch.Tensor,
                        generator: Optional[torch.Generator],
                        occ_grid, chunk: int,
                        fine_model=None) -> torch.Tensor:
    """The final rgb (R, 3) f32 of rays (R, 3) under one shape and one
    texture code, through the forward kernels, forward only; R a multiple
    of ``chunk``. The four-plane forward runs on the fine network
    (:func:`fine_network`) at the union of coarse and fine depths when
    ``n_importance > 0``, else on ``model`` at the coarse depths, whatever
    ``fine_model`` is given.

    Span ``render.operands``, once a call: ``fused_train.trunk_operands``
    of each network (packed once per weight version) and the code
    projections (``fused_mlp.code_operands`` of the one code, copied to a
    launch's rows); and once a group of whole chunks up to
    :data:`KERNEL_RAYS` rays: the depths of :func:`coarse_zvals` (and a
    random render's fine probes), drawn chunk by chunk in the order the
    plain route draws them (:func:`_draws`), and the rays' operands
    (``fused_mlp.ray_operands``). Hierarchical only, span
    ``render.coarse``: the group's one sigma-only forward
    (``fused_mlp.sigma_fwd``) on ``model`` and the compositing weights;
    span ``render.resample``: :func:`fine_zvals` and the sorted union.
    Span ``render.chunk``: the group's one four-plane forward
    (``fused_mlp.planes_fwd``) and one composite kernel
    (``ops/composite.composite_fwd``). No coarse rgb is computed.
    ``render_image.samples`` counts the points each forward evaluated
    (``coarse_sigma``, ``planes``). On CPU tensors the kernels run their
    plain versions."""
    # the rays as an R x 1 image
    return _kernels_finish(_kernels_prepare(PreparedImage(
        model=model, rcfg=rcfg, H=ray_o.shape[0], W=1, shape_code=shape_code,
        texture_code=texture_code, generator=generator, chunk=chunk,
        compute_dtype=torch.bfloat16, occ_grid=occ_grid,
        fine_model=fine_model, kernels=True, ray_o=ray_o, viewdir=viewdir)))


def _on_host(x) -> bool:
    return not (torch.is_tensor(x) and x.device.type != "cpu")


def _pose_host(c2w, focal) -> np.ndarray:
    """``c2w``'s values then ``focal``, float32, on the host."""
    return np.concatenate([np.asarray(c2w, dtype=np.float32).reshape(-1),
                           np.asarray(focal, dtype=np.float32).reshape(1)])


def _pose_up(c2w, focal, dev):
    """``c2w`` and ``focal`` from the host for :func:`camera_rays` on the
    CUDA device ``dev``: as float32 in one pinned buffer, without a
    stream synchronisation (a copy from pageable memory, or a tensor made
    there from a Python number, synchronises the stream); the focal stays
    a float32 device value, so that the rays' division rounds as
    before."""
    up = torch.from_numpy(_pose_host(c2w, focal)).pin_memory().to(
        dev, non_blocking=True)
    return up[:-1].view(np.shape(c2w)), up[-1]


def _with_rays(p: PreparedImage, c2w, focal) -> PreparedImage:
    """``p`` with the image's camera rays, padded to whole chunks."""
    n = -(-p.H * p.W // p.chunk) * p.chunk
    ray_o, viewdir = camera_rays(p.H, p.W, focal, c2w,
                                 device=p.shape_code.device)
    return p._replace(ray_o=pad_rays(ray_o, n), viewdir=pad_rays(viewdir, n))


def _cloned(x):
    """``x`` with every tensor in it, through tuples and lists, a copy."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (tuple, list)):
        items = [_cloned(v) for v in x]
        return x._make(items) if hasattr(x, "_make") else type(x)(items)
    return x


# The deterministic prepare on the card as CUDA graphs: one launch in
# place of its ~85 small ones. Each of those gives up the interpreter
# lock and waits to take it back, which on a busy server (handler
# threads, the render's own host) made the prepare, not the device, set
# the rate. model -> {key: _PrepareGraph or None (capture failed)}, at
# most _GRAPHS_KEPT keys a model, the oldest dropped first.
_PREPARE_GRAPHS = weakref.WeakKeyDictionary()
_GRAPHS_KEPT = 4
_GRAPHS_LOCK = threading.Lock()


class _PrepareGraph:
    """:func:`_kernels_prepare` of one image's rays, without a generator,
    captured for one image size, render configuration and pair of
    networks: static inputs (the pose and focal, and the two codes), the
    captured record (without the networks, which no reference keeps
    alive, and their trunk operands, packed anew when the weights
    changed), and the parameters it reads (``fused_train._weights_key``
    without versions: it reads their values at each replay, and a
    replaced parameter makes it stale)."""

    def __init__(self, p: PreparedImage, pose_shape):
        self.keys = [[(ref, ptr, None) for ref, ptr, _ in
                      fused_train._weights_key(m)]
                     for m in (p.model, p.fine_model) if m is not None]
        self.lock = threading.Lock()
        self.pose = torch.zeros(int(np.prod(pose_shape)) + 1,
                                dtype=torch.float32,
                                device=p.shape_code.device)
        self.codes = (torch.zeros_like(p.shape_code),
                      torch.zeros_like(p.texture_code))

        def body():
            return _kernels_prepare(_with_rays(
                p._replace(shape_code=self.codes[0],
                           texture_code=self.codes[1]),
                self.pose[:-1].view(pose_shape), self.pose[-1]))

        body()          # warm-up; packs the trunk operands if need be
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            out = body()
        self.out = out._replace(model=None, fine_model=None, trunk=None,
                                trunk_c=None)

    def run(self, p: PreparedImage, c2w, focal) -> PreparedImage:
        """The captured prepare at ``p``'s codes, ``c2w`` and ``focal``:
        ``p`` completed by a copy of every tensor the replay wrote (the
        next replay writes over them), in stream order."""
        host = torch.from_numpy(_pose_host(c2w, focal)).pin_memory()
        with self.lock:
            self.pose.copy_(host, non_blocking=True)
            self.codes[0].copy_(p.shape_code)
            self.codes[1].copy_(p.texture_code)
            self.graph.replay()
            return _with_trunks(PreparedImage(*(
                _cloned(b) if a is None else a
                for a, b in zip(p, self.out))))


def _prepare_graph(p: PreparedImage, c2w) -> Optional[_PrepareGraph]:
    """The :class:`_PrepareGraph` of this render, captured on first use;
    None where capture failed."""
    key = (p.rcfg, p.H, p.W, p.chunk, id(p.fine_model), np.shape(c2w),
           *((c.shape, c.dtype, c.device) for c in (p.shape_code,
                                                    p.texture_code)))
    with _GRAPHS_LOCK:
        graphs = _PREPARE_GRAPHS.setdefault(p.model, {})
        g = graphs.get(key, False)
        if g is None or (g and all(fused_train._key_holds(k, m) for k, m in
                                   zip(g.keys, (p.model, p.fine_model)))):
            return g
        graphs.pop(key, None)
        if len(graphs) >= _GRAPHS_KEPT:
            del graphs[next(iter(graphs))]
        try:
            g = _PrepareGraph(p, np.shape(c2w))
        except RuntimeError:
            g = None
        graphs[key] = g
        return g


@torch.no_grad()
def prepare_image(model, rcfg: RenderConfig, H: int, W: int, focal, c2w,
                  shape_code: torch.Tensor, texture_code: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  chunk: int = 4096,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  occ_grid=None, fine_model=None) -> PreparedImage:
    """The first stage of :func:`render_image` (same arguments):
    everything before the first forward launch. The pose's upload (no
    stream synchronisation) and the padded camera rays (span
    ``render.rays``); on the kernel route also the networks' operands and
    the first launch group's (a 128 x 128 view is one group). On the
    card, on the kernel route without a generator or an occupancy grid
    and from a pose and focal on the host, all of it is one CUDA graph's
    replay (captured on first use for the image size, render
    configuration and networks; span ``render.operands``)."""
    dev = shape_code.device
    chunk = chunk_plan(H * W, chunk)[0]
    p = PreparedImage(
        model=model, rcfg=rcfg, H=H, W=W, shape_code=shape_code,
        texture_code=texture_code, generator=generator, chunk=chunk,
        compute_dtype=compute_dtype, occ_grid=occ_grid, fine_model=fine_model,
        kernels=kernel_route(model, rcfg, chunk, compute_dtype, dev,
                             fine_model))
    up = dev.type == "cuda" and _on_host(c2w) and _on_host(focal)
    if p.kernels and up and generator is None and occ_grid is None:
        graph = _prepare_graph(p, c2w)
        if graph is not None:
            with span("render.operands"):
                return graph.run(p, c2w, focal)
    with span("render.rays"):
        p = _with_rays(p, *(_pose_up(c2w, focal, dev) if up
                            else (c2w, focal)))
    return _kernels_prepare(p) if p.kernels else p


@torch.no_grad()
def finish_image(p: PreparedImage) -> torch.Tensor:
    """The second stage of :func:`render_image`: every forward launch of
    a render :func:`prepare_image` prepared, in the order
    :func:`render_image` makes them; (H, W, 3) f32."""
    if p.kernels:
        rgb = _kernels_finish(p)
    else:
        parts = []
        for i in range(0, p.ray_o.shape[0], p.chunk):
            with span("render.chunk"):
                parts.append(render_rays(
                    p.model, p.rcfg, p.ray_o[i:i + p.chunk],
                    p.viewdir[i:i + p.chunk], p.shape_code, p.texture_code,
                    p.generator, compute_dtype=p.compute_dtype,
                    occ_grid=p.occ_grid, fine_model=p.fine_model).final.rgb)
        rgb = torch.cat(parts)
    ROUTE_CHUNKS["kernels" if p.kernels else "plain"] += (
        p.ray_o.shape[0] // p.chunk)
    return rgb[:p.H * p.W].reshape(p.H, p.W, 3)


@torch.no_grad()
def render_image(model, rcfg: RenderConfig, H: int, W: int, focal, c2w,
                 shape_code: torch.Tensor,
                 texture_code: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 chunk: int = 4096,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 occ_grid=None, fine_model=None,
                 prepared: Optional[PreparedImage] = None) -> torch.Tensor:
    """Render a full H×W image in fixed-size ray chunks; (H, W, 3) f32:
    ``finish_image`` of ``prepared``, by default ``prepare_image`` of the
    same arguments (a server passes its own, prepared ahead), on the
    route :func:`kernel_route` chooses (``fine_model``: the separate fine
    network). While a profiler records, the camera rays are the span
    ``render.rays`` and each chunk (on the kernel route each launch's
    group of chunks) a ``render.chunk``."""
    if prepared is None:
        prepared = prepare_image(model, rcfg, H, W, focal, c2w, shape_code,
                                 texture_code, generator, chunk,
                                 compute_dtype, occ_grid, fine_model)
    return finish_image(prepared)


render_image.chunks = ROUTE_CHUNKS
render_image.samples = KERNEL_SAMPLES
