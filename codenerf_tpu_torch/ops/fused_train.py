"""Single-pass CodeNeRF loss kernel for Hopper, in its modes.

Replaces ``codenerf_tpu/ops/fused_train.py::_train_kernel`` (launched by
``invoke_train_fused``). Per ray: xyz = ro + vd·z and its 64-lane
positional encoding, the trunk (bf16 matmuls, f32 accumulation, per-ray
latent injection), softplus sigma and the rgb head, the volume-rendering
composite, the per-ray squared error, the cotangent 2·scale·(rgb − gt), the
composite backward, and the dx chain down to shape block 0, written as the
per-ray bf16 ray sums ``d_sproj``, ``d_tproj``, ``d_vcontrib``.

- ``weight_grads=False`` (with or without ``want_rgb``): the frozen-model
  mode of test-time code optimization.
- ``weight_grads=True``: category training. It also returns every weight's
  and bias's f32 gradient summed over all points, in :func:`weight_shapes`
  order: ``dW = x^T @ gh`` and ``db = Σ gh`` per layer (x the layer's bf16
  input, gh its bf16 output cotangent), ``Σ t·dsig`` and ``Σ dsig`` for
  the sigma head.
- the dual composite (``coarse_mask``, ``coarse_delta``), in either mode:
  hierarchical sampling's one evaluation at the union of the coarse and
  fine depths, which composites both and returns the fine and the coarse
  squared errors, every cotangent that of their sum (the TPU kernel's
  ``dual=True``). At W=256, nb=3, nt=1 and 16,384 rays × 64 union samples
  a training call is 2.75e12 FLOP, 2.78 ms at 989 TFLOP/s; a frozen call
  at 4096 × 64 is 4.55e11 FLOP, 0.46 ms.
- ``input_grads=True`` with ``weight_grads=False`` (pose optimization):
  the dx chain runs on through enc_xyz's ReLU mask, and the exact
  cotangents of the rays and depths ``(d_ro8, d_vd8, d_z)`` follow — the
  PE Jacobian chain plus the composite's own z term; with
  ``want_weights`` also the (R, S) compositing weights (the hierarchical
  coarse call). The input chain adds 2·64·W FLOP per point to the frozen
  mode's, 1,769,472 per point at W=256, nb=3, nt=1: 0.35 ms for 2048 rays
  × 96 samples, 0.12 ms for 2048 × 32, 0.23 ms for 2048 × 64.
- the pairs no path calls, as the TPU kernel has them: ``input_grads``
  with weight gradients (one pass gives the dW/db and the ray and depth
  cotangents), and ``want_weights`` without ``input_grads`` (the weights
  plane beside the code cotangents: the JAX package's former two-call
  hierarchical training route).

The dual mode excludes ``want_weights`` and ``input_grads``, as on the
TPU.

The plane op (:class:`PlaneOp`, the TPU package's ``_make_plane_op``),
replacing ``codenerf_tpu/ops/fused_train.py::_bwd_kernel`` (launched by
``_invoke_bwd``) with :func:`plane_bwd`: the same ``fused_step``
recomputes the forward and, where the single pass composites, takes the
outside cotangents of the four planes ``fused_mlp.planes_fwd`` returns;
the chains follow by flag, all four flag pairs (``plane_train``,
``plane_codes``, ``plane_pose``, ``plane_train_input``). Per point it
recomputes the forward (884,736 FLOP at W=256, nb=3, nt=1) and runs the
dx chain (851,968), plus the dW products (884,736) with weight gradients
and the input chain (32,768) with input gradients: 2.78 ms for a
training call at 16,384 × 64 at 989 TFLOP/s, 0.46 ms for a frozen one at
4096 × 64, 0.23 ms for a pose one at 2048 × 64. Recomputing keeps the
forward call stateless, as the TPU design does; its factories
(:func:`make_fused_train_op`, :func:`make_fused_codes_op`,
:func:`make_fused_pose_op`, the ``*_composite_op`` s through
``ops/composite.py``) and :func:`fused_apply_train` /
:func:`fused_render_train` are the JAX package's.

What bounds it on an H100. Matmul operations per point: forward
2W(64 + W(nb+nt+2) + W/2), the dx chain 2W(W(nb+nt+2) + W/2) and, with
weight gradients, the dW products as many as the forward. At W=256, nb=3,
nt=1 that is 884,736 + 851,968 (+ 884,736) FLOP per point: for a 4096-ray
× 96-sample call without weight gradients 6.8e11 FLOP, 0.69 ms at
989 TFLOP/s dense bf16; for a 16,384-ray × 96-sample training step
4.12e12 FLOP, 4.17 ms. The bytes the function must move (its inputs and
outputs, the weights and their f32 gradients) are ~25 MB and ~0.1 GB,
7.5 µs and ~0.03 ms at 3.35 TB/s, so both modes are bound by operations.

The design (``csrc/train_fused.cu``). The TPU kernel keeps all weights and
every activation of a 16-ray tile (~6 MB) resident in VMEM, and in
training its dW/db blocks stay resident as accumulators over the
sequential grid; an H100 block has 227 KB of shared memory and blocks run
in no order. Here the trunk runs as two chained ``wgmma`` kernels that keep
a 128-point tile's activations in shared memory across layers and stream
the weights from L2 through a ring filled by bulk copies, from operands
packed once per weight version (:func:`trunk_operands`, one
``pack_kernel`` launch; :func:`wgmma_pack` is the layout's plain
version):
``trunk_fwd_kernel`` (the PE, every forward layer, the latent
injections; it stores only the planes later kernels read) and
``trunk_dx_kernel`` (the dx chain from the rgb_hidden cotangent down, the
ReLU masks, the sigma term and the per-ray row sums in its epilogue:
one partial row per ray and 16-point warp slice, no atomics). Between
them ``head_kernel``, a warp per ray — the sigma and rgb heads from 16-byte rows of t and r, the
composite as a warp scan over the samples, the loss and the composite
backward, and in training the per-ray sums of the sigma and rgb_out
gradients, added over a block's rays in order. In training the dx kernel
also stores every gh plane, and ``wgrad_kernel`` (:func:`weight_grads`)
forms every trunk layer's dW/db in one launch: two-block clusters walk a
fixed list of (layer, point split) items, wgmma over TMA-loaded boxes of
the stored planes, one block's half of the shared operand multicast to
both, each item's f32 partial written without atomics; one
``fixed_sum_kernel`` launch adds the splits and the head's rows in a fixed
order — so dW and db are the same bits on every run, and so are the
per-ray code cotangents: one ``ray_sum_fold_kernel`` launch adds each
ray's partial rows left to right and rounds all three to bf16 last
(:func:`fold_ray_sums` alone; :func:`ray_sums_plain` and
:func:`fold_ray_sums_plain` are the two stages' plain versions);
with input gradients the head kernel also writes the weights and the
composite's dz, and an input-chain kernel (one block per ray, W_enc^T in
shared memory, fixed-order sums) finishes d_ro8, d_vd8 and d_z, the same
bits on every run. The CUDA kernels take W = 256.

Beside the kernel: :func:`train_fused_plain`, the same function in plain
PyTorch (the CPU tests and ``chip_smoke.py`` use it; the main path never
does on CUDA) with its parts :func:`head_plain` and
:func:`weight_grads_plain`, the launch counters ``train_fused.launches``
(one per mode: ``codes``, ``train``, ``dual_codes``, ``dual_train``,
``pose``, ``pose_weights``, ``train_input``, ``train_weights`` ...;
``train_fused.points`` sums the R·S of those launches,
``train_fused.bulk_planes`` the planes their forward stored from the
trunk kernel's tile by TMA: t and r, and in the weight-gradient modes
the PE, the injected inputs and the last blocks' outputs),
:func:`hier_fine_zvals_meta`, which draws the fine depths and the dual
mode's planes, the layout of the trunk kernels' weights
(:func:`wgmma_pack`, :func:`pack_trunk_weights_plain`), the cache of
packed operands (:func:`trunk_operands`, :func:`drop_trunk_operands`;
every wrapper on CUDA tensors takes its weights as such a
:class:`TrunkOperands`, :func:`fresh_trunk_operands` builds one
uncached), and the
``autograd.Function`` s :class:`FusedCodesLoss` (codes only),
:class:`FusedPoseLoss` (rays, depths and codes) and :class:`FusedTrainLoss`
(codes and weights), which hand the kernel's cotangents to the prologue's
backward.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import List, Optional, Tuple

import torch

from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.core.sampling import (merge_sorted_samples,
                                              sample_pdf, union_sorted_zvals)
from codenerf_tpu_torch.ops import fused_mlp

# The TPU kernel's ray tile. The CUDA kernel does not tile rays this way,
# but the port keeps the TPU's eligibility rule so both packages take the
# single-pass route on the same problems.
_TRAIN_TILE_RAYS = 16
_KERNEL = "train_fused"
_MAX_SAMPLES = 256   # the head kernel's scan holds 8 samples per lane
TRUNK_W = 256        # the trunk kernels' width (shared-memory tiles)


def single_pass_available(cfg: NetConfig, n_rays: int) -> bool:
    return (cfg.W % 256 == 0 and cfg.d_xyz <= 64 and cfg.shape_blocks >= 1
            and cfg.texture_blocks >= 1 and n_rays % _TRAIN_TILE_RAYS == 0)


def weight_shapes(cfg: NetConfig) -> List[Tuple[str, tuple, tuple]]:
    """(name, w_shape, b_shape) in operand order. enc_viewdir's bias rides
    in vcontrib, so its slot is a zero vector."""
    W = cfg.W
    shapes = [("enc_xyz", (64, W), (W,))]
    shapes += [(f"shape_{j}", (W, W), (W,)) for j in range(cfg.shape_blocks)]
    shapes += [("enc_shape", (W, W), (W,)), ("sigma", (W,), (1,)),
               ("enc_viewdir_pt", (W, W), (W,))]
    shapes += [(f"texture_{j}", (W, W), (W,))
               for j in range(cfg.texture_blocks)]
    shapes += [("rgb_hidden", (W, W // 2), (W // 2,)),
               ("rgb_out", (W // 2, 8), (8,))]
    return shapes


def flatten_params(model, cfg: NetConfig) -> List[torch.Tensor]:
    """The kernel's f32 weight operands from a ``CodeNeRF``: 2-D weights
    (in, out), enc_xyz padded to 64 rows, rgb_out padded to 8 columns, the
    sigma row as a (W,) vector, enc_viewdir's trunk rows [:W].
    Differentiable, as ``flatten_params_f32`` is in the JAX package: the
    kernel's dW/db flow back through the transposes, pads and slices into
    the model's parameters (a frozen model simply has none that require
    gradients)."""
    W = cfg.W

    def wt(name):
        return getattr(model, name).weight.float().T

    def bias(name):
        return getattr(model, name).bias.float()

    def pad(x, rows=None, cols=None):
        r = (rows or x.shape[0]) - x.shape[0]
        c = (cols or x.shape[1]) - x.shape[1]
        return torch.nn.functional.pad(x, (0, c, 0, r))

    out = [pad(wt("enc_xyz"), rows=64), bias("enc_xyz")]
    for j in range(cfg.shape_blocks):
        out += [wt(f"shape_{j}"), bias(f"shape_{j}")]
    out += [wt("enc_shape"), bias("enc_shape")]
    out += [model.sigma.weight.float()[0], bias("sigma")]
    out += [model.enc_viewdir.weight.float()[:, :W].T,
            torch.zeros(W, device=model.enc_viewdir.weight.device)]
    for j in range(cfg.texture_blocks):
        out += [wt(f"texture_{j}"), bias(f"texture_{j}")]
    out += [wt("rgb_hidden"), bias("rgb_hidden")]
    out += [pad(wt("rgb_out"), cols=8),
            torch.nn.functional.pad(bias("rgb_out"), (0, 5))]
    return [x.contiguous() for x in out]


kernel_operands = fused_mlp.kernel_operands


def _swizzle_index(N: int, device) -> torch.Tensor:
    """(N, 8): for row n and 16-byte chunk position p, the chunk c = p ^
    (n % 8) that the 128-byte swizzle puts there (an involution: it also
    maps chunks to positions)."""
    return (torch.arange(8, device=device)[None, :]
            ^ (torch.arange(N, device=device) % 8)[:, None])


def wgmma_pack(b: torch.Tensor) -> torch.Tensor:
    """A bf16 matrix ``B (N, K)`` in the trunk kernels' operand layout, flat
    (N·K,): 64-deep K slices one after another, each N rows of 64 values
    (128 B) with the 16-byte chunk c of row n at position c ^ (n % 8) — the
    K-major, 128-byte-swizzled layout ``wgmma`` reads from shared memory,
    so that a slice goes there in one bulk copy. The CUDA kernels pack
    with ``pack_kernel``; this is its plain version."""
    N, K = b.shape
    if K % 64 or N % 8:
        raise ValueError(f"wgmma_pack: B is {(N, K)}; N % 8 and K % 64 "
                         "must be 0")
    x = b.reshape(N, K // 64, 8, 8).permute(1, 0, 2, 3)      # (s, n, c, e)
    idx = _swizzle_index(N, b.device)[None, :, :, None].expand(K // 64, N,
                                                                8, 8)
    return torch.gather(x, 2, idx).reshape(-1)


def wgmma_unpack(flat: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """The inverse of :func:`wgmma_pack`: ``B (N, K)``."""
    x = flat.reshape(K // 64, N, 8, 8)                         # (s, n, p, e)
    idx = _swizzle_index(N, flat.device)[None, :, :, None].expand(K // 64,
                                                                   N, 8, 8)
    return torch.gather(x, 2, idx).permute(1, 0, 2, 3).reshape(N, K)


def trunk_layer_indices(cfg: NetConfig) -> List[int]:
    """Each trunk layer's weight index in :func:`weight_shapes` order, in
    forward order: enc_xyz, the shape blocks, enc_shape, enc_viewdir's
    trunk rows, the texture blocks, rgb_hidden (the sigma and rgb_out
    heads are not GEMMs of the trunk)."""
    nb, nt = cfg.shape_blocks, cfg.texture_blocks
    return [0, *range(1, nb + 2), *range(nb + 3, nb + nt + 5)]


def pack_trunk_weights_plain(cfg: NetConfig, wops) -> torch.Tensor:
    """The packed weight operands of the trunk kernels, as
    ``pack_trunk_weights`` in ``csrc/train_fused.cu`` packs them: the
    forward's ``wgmma_pack(W^T)`` of every trunk layer, then the dx
    chain's ``wgmma_pack(W)`` of every layer but enc_xyz, for W the bf16
    (in, out) operands of :func:`kernel_operands`."""
    ws = [wops[2 * i] for i in trunk_layer_indices(cfg)]
    return torch.cat([wgmma_pack(w.T.contiguous()) for w in ws]
                     + [wgmma_pack(w) for w in ws[1:]])


def pack_trunk_weights(cfg: NetConfig, wflat) -> torch.Tensor:
    """:func:`pack_trunk_weights_plain` by the CUDA packer (CUDA operands
    only): the ``packed`` operand of the trunk kernels, one
    ``pack_kernel`` launch, counted in
    ``pack_trunk_weights.launches["pack"]``. :func:`trunk_operands` calls
    it once per weight version; no kernel call packs for itself."""
    dev = wflat[0].device
    if dev.type != "cuda":
        raise ValueError("pack_trunk_weights packs CUDA operands; "
                         "pack_trunk_weights_plain is its plain version")
    lib = library()
    wops = checked_weights(cfg, wflat, dev)
    out = torch.empty(lib.packed_trunk_elems(cfg.W, cfg.shape_blocks,
                                             cfg.texture_blocks),
                      dtype=torch.bfloat16, device=dev)
    wptrs, _keep = _ptr_array(wops)
    rc = lib.pack_trunk_weights(
        wptrs, cfg.W, cfg.shape_blocks, cfg.texture_blocks, _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"pack_trunk_weights failed: cudaError {rc}")
    pack_trunk_weights.launches["pack"] += 1
    return out


pack_trunk_weights.launches = {"pack": 0}


TrunkOperands = fused_mlp.TrunkOperands


def fresh_trunk_operands(cfg: NetConfig, wflat) -> TrunkOperands:
    """The :class:`TrunkOperands` of the weights ``wflat`` holds, built
    now and cached nowhere: on the card packed by
    :func:`pack_trunk_weights` (which raises on failure)."""
    with torch.no_grad():
        wops = [_aligned(w, w.dtype).detach() for w in kernel_operands(wflat)]
        packed = (pack_trunk_weights(cfg, wops) if wops[0].is_cuda
                  else None)
    return TrunkOperands(wops, packed)


# model -> (cfg, key, TrunkOperands).
_TRUNK_CACHE = weakref.WeakKeyDictionary()


def _weights_key(model):
    """What state derived from ``model``'s parameters depends on: for
    each, a weak reference, its data_ptr() and its _version (an address
    alone could be a freed tensor's, reused by the caching allocator).
    State that reads the values anew at each use (the renderer's CUDA
    graphs) keeps the key with None for each version."""
    return [(weakref.ref(p), p.data_ptr(), p._version)
            for p in model.parameters()]


def _key_holds(key, model) -> bool:
    """Whether ``model``'s parameters are still those of ``key``: the
    same tensors at the same addresses, at the same versions where the
    key has one."""
    params = list(model.parameters())
    return len(key) == len(params) and all(
        ref() is p and ptr == p.data_ptr() and ver in (None, p._version)
        for (ref, ptr, ver), p in zip(key, params))


def trunk_operands(model, cfg: NetConfig) -> TrunkOperands:
    """``model``'s :class:`TrunkOperands`, from the cache while none of its
    parameters changed: the same object, and no packing, as long as every
    parameter is the same tensor at the same address and version.
    Otherwise :func:`fresh_trunk_operands` rebuilds them (counted in
    ``trunk_operands.builds``). An in-place update of a parameter bumps
    its version. Two kinds of write do not, and whatever makes them calls
    :func:`drop_trunk_operands`: ``torch.optim.AdamW(fused=True)``
    (``training/train_step.apply_update`` drops every network it
    updates), and an in-place write through ``.data``
    (``p.data.copy_(w)``, ``p.data.mul_(s)``: ``.data`` has a version
    counter of its own and keeps the address) — without the drop the
    kernels would run on the old weights and raise nothing."""
    hit = _TRUNK_CACHE.get(model)
    if hit is not None and hit[0] == cfg and _key_holds(hit[1], model):
        return hit[2]
    trunk = fresh_trunk_operands(cfg, flatten_params(model, cfg))
    _TRUNK_CACHE[model] = (cfg, _weights_key(model), trunk)
    trunk_operands.builds += 1
    return trunk


trunk_operands.builds = 0


def drop_trunk_operands(model) -> None:
    """Forget ``model``'s cached :class:`TrunkOperands`: the next
    :func:`trunk_operands` rebuilds them."""
    _TRUNK_CACHE.pop(model, None)


def _cuda_trunk(cfg: NetConfig, weights, dev) -> TrunkOperands:
    """The :class:`TrunkOperands` ``weights`` of a CUDA call, checked
    against the config and the device. A CUDA call never packs: a weight
    list is refused."""
    if not isinstance(weights, TrunkOperands):
        raise TypeError("a CUDA kernel call takes its weights as "
                        "TrunkOperands (trunk_operands or "
                        "fresh_trunk_operands), not a weight list")
    n = library().packed_trunk_elems(cfg.W, cfg.shape_blocks,
                                     cfg.texture_blocks)
    pk = weights.packed
    if (pk is None or pk.dtype != torch.bfloat16 or pk.numel() != n
            or pk.device != dev or not pk.is_contiguous()):
        raise ValueError(f"trunk operands: packed weights "
                         f"{None if pk is None else (pk.dtype, pk.shape)} "
                         f"on {None if pk is None else pk.device}, expected "
                         f"{n} bf16 on {dev}")
    return TrunkOperands(checked_weights(cfg, weights.wops, dev), pk)


def hier_fine_zvals(z2d: torch.Tensor, w_coarse: torch.Tensor,
                    generator: Optional[torch.Generator], n_importance: int,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The union of the coarse depths and ``n_importance`` importance
    samples drawn from the interior coarse weights over the z midpoints,
    sorted per ray: what the fine pass evaluates. ``u`` replaces the
    generator's uniforms (the tests feed both packages the same draws)."""
    z_mid = 0.5 * (z2d[:, 1:] + z2d[:, :-1])
    z_fine = sample_pdf(z_mid, w_coarse[:, 1:-1], n_importance, generator,
                        u=u)
    return union_sorted_zvals(z2d, z_fine)


def hier_fine_zvals_meta(z2d: torch.Tensor, w_coarse: torch.Tensor,
                         generator: Optional[torch.Generator],
                         n_importance: int, u: Optional[torch.Tensor] = None):
    """:func:`hier_fine_zvals` plus the planes of the dual-composite mode:
    ``(z_all, cmask, cdelta)``, each (R, Sc+Sf) f32. ``cmask`` is 1.0 where
    the sample came from the coarse pass; ``cdelta`` holds the
    consecutive-coarse deltas there (1e10 at the last coarse sample) and 0
    at fine samples. One stable sort gives the union and both planes with
    the permutation ``union_sorted_zvals`` uses."""
    z_mid = 0.5 * (z2d[:, 1:] + z2d[:, :-1])
    z_fine = sample_pdf(z_mid, w_coarse[:, 1:-1], n_importance, generator,
                        u=u)
    cdelta = torch.cat([z2d[:, 1:] - z2d[:, :-1],
                        torch.full_like(z2d[:, :1], 1e10)], dim=-1)
    zeros_f = torch.zeros_like(z_fine)
    z_all, (cmask, cdelta_u) = merge_sorted_samples(
        z2d, z_fine, [torch.ones_like(z2d), cdelta], [zeros_f, zeros_f])
    return z_all, cmask, cdelta_u


def _check_mode(weight_grads, want_weights, input_grads, coarse_mask,
                coarse_delta):
    if (coarse_mask is None) != (coarse_delta is None):
        raise ValueError("coarse_mask and coarse_delta come together")
    if coarse_mask is not None and (want_weights or input_grads):
        raise ValueError("the dual-composite mode excludes want_weights and "
                         "input_grads (its coarse weights come from the "
                         "sigma-only forward; it never differentiates z)")


def _mode(weight_grads: bool, dual: bool, want_weights: bool = False,
          input_grads: bool = False) -> str:
    if input_grads and not weight_grads:
        return "pose_weights" if want_weights else "pose"
    return (("dual_" if dual else "") + ("train" if weight_grads else "codes")
            + ("_input" if input_grads else "")
            + ("_weights" if want_weights else ""))


def train_fused(cfg: NetConfig, S: int, R: int, white_bg: bool,
                scale: float, ro8, vd8, z, sproj, tproj, vcontrib, gt8,
                weights, want_weights: bool = False, want_rgb: bool = False,
                weight_grads: bool = True, input_grads: bool = False,
                coarse_mask=None, coarse_delta=None):
    """Counterpart of ``invoke_train_fused``: returns ``(se_sum () f32,
    d_sproj (R, nb, W) bf16, d_tproj (R, nt, W) bf16, d_vcontrib (R, W)
    bf16[, weights (R, S) f32][, rgb8 (R, 8) f32][, d_ro8 (R, 8), d_vd8
    (R, 8), d_z (R, S) f32][, dW_0, db_0, dW_1, ...])``, the weight and
    bias gradients f32 in :func:`weight_shapes` order. Every cotangent is
    that of ``scale · se_sum`` (the kernel's cotangent is 2·scale·diff).

    ``input_grads`` adds the exact cotangents of the rays and depths, the
    PE Jacobian chain through enc_xyz plus the composite's own z term
    (with ``weight_grads=False``: the pose modes); ``want_weights`` adds
    the compositing weights (with ``input_grads``: the hierarchical coarse
    call of pose optimization).

    ``coarse_mask`` and ``coarse_delta`` ((R, S) f32, from
    :func:`hier_fine_zvals_meta`) select the dual-composite mode: ``z`` is
    the union of coarse and fine depths, the coarse composite is computed
    from the same evaluation, the return gains ``se_coarse`` after
    ``se_sum`` (then the fine SE), and every cotangent is that of
    ``scale · (se_fine + se_coarse)``.

    ``weights``: the network's :class:`TrunkOperands`
    (:func:`trunk_operands`), whose packed operands the CUDA kernels read;
    on CPU tensors also the :func:`flatten_params` list.

    On CPU tensors this is :func:`train_fused_plain`; on CUDA tensors it
    launches the CUDA kernels (and counts the launch in its mode's
    counter, ``train_fused.launches``, and its R·S points in
    ``train_fused.points``: ``codes``, ``train``, ``dual_codes``,
    ``dual_train``, ``pose``, ``pose_weights``, ``train_input``,
    ``train_weights``, ``codes_weights``, ``train_input_weights``)."""
    _check_mode(weight_grads, want_weights, input_grads, coarse_mask,
                coarse_delta)
    if z.shape != (R, S):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {(R, S)}")
    if z.device.type == "cpu":
        return train_fused_plain(cfg, S, R, white_bg, scale, ro8, vd8, z,
                                 sproj, tproj, vcontrib, gt8, weights,
                                 want_rgb=want_rgb, weight_grads=weight_grads,
                                 coarse_mask=coarse_mask,
                                 coarse_delta=coarse_delta,
                                 want_weights=want_weights,
                                 input_grads=input_grads)
    if z.device.type != "cuda":
        raise ValueError(f"train_fused: unsupported device {z.device}")
    outs = _launch_cuda(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                        tproj, vcontrib, gt8, weights, want_weights, want_rgb,
                        weight_grads, input_grads, coarse_mask, coarse_delta)
    mode = _mode(weight_grads, coarse_mask is not None, want_weights,
                 input_grads)
    train_fused.launches[mode] += 1
    train_fused.points[mode] += R * S
    train_fused.bulk_planes[mode] += library().forward_bulk_planes()
    return outs


train_fused.launches = {m: 0 for m in (
    "codes", "train", "dual_codes", "dual_train", "pose", "pose_weights",
    "train_input", "train_weights", "codes_weights", "train_input_weights")}
train_fused.points = dict(train_fused.launches)
train_fused.bulk_planes = dict(train_fused.launches)


def train_fused_plain(cfg: NetConfig, S: int, R: int, white_bg: bool,
                      scale: float, ro8, vd8, z, sproj, tproj, vcontrib,
                      gt8, wflat, want_rgb: bool = False,
                      weight_grads: bool = False, sigma_terms=None,
                      coarse_mask=None, coarse_delta=None,
                      want_weights: bool = False, input_grads: bool = False):
    """The kernel's function in plain PyTorch, rounding where the TPU
    kernel rounds: bf16 activations after each ReLU, the latent injection
    as a bf16 add, sig_pre in f32 from bf16 t, ReLU masks on the stored
    bf16 activations, the composite in f32; each output cotangent gh
    rounded to bf16 before both its dx and its dW product (exact bf16
    products, f32 sums), the sigma dW from bf16 t times f32 dsig. In the
    dual mode the two composites' sigma and rgb cotangents are added
    before the one backward chain. ``input_grads`` continues the chain
    through enc_xyz's ReLU mask into :func:`fused_mlp.input_chain_plain`.

    ``sigma_terms``, a list, receives ``(Σ|t·dsig| (W,), Σ|dsig| (1,))``:
    the size of the terms of the sigma head's gradient sums, which cancel
    heavily (comparisons scale their bar by it)."""
    wops = kernel_operands(wflat)
    acts = fused_mlp.forward_plain(cfg, R, S, ro8, vd8, z, sproj, tproj,
                                   vcontrib, wops)
    ses, out8, weights, g_sigma, (gc0, gc1, gc2), dz_comp = head_plain(
        R, S, acts["sig_pre"], acts["rgb"], z, gt8, white_bg, scale,
        coarse_mask, coarse_delta)

    d_sproj, d_tproj, d_vcontrib, gh0, dwb = backward_chain_plain(
        cfg, R, S, acts, sproj, tproj, wops, g_sigma, (gc0, gc1, gc2),
        weight_grads, input_grads, sigma_terms)
    outs = ses + (d_sproj, d_tproj, d_vcontrib)
    if want_weights:
        outs += (weights,)
    if want_rgb:
        outs += (out8,)
    if input_grads:
        outs += fused_mlp.input_chain_plain(R, S, ro8, vd8, z, gh0, wops[0],
                                            dz_comp, cfg.num_xyz_freq)
    return outs + tuple(dwb)


def head_plain(R: int, S: int, sig_pre, rgb, z, gt8, white_bg: bool,
               scale: float, coarse_mask=None, coarse_delta=None):
    """The composite part of the head kernel in plain PyTorch, from the
    forward's sigma pre-activation ``sig_pre`` (R, S) f32 and rgb_out rows
    ``rgb`` (R·S, 8) f32 (:func:`fused_mlp.forward_plain`): softplus, the
    volume-rendering composite (in the dual mode both composites), the
    squared error against ``gt8`` and its cotangent 2·scale·(rgb − gt),
    and the composite backward — the TPU kernel's head
    (``codenerf_tpu/ops/fused_train.py:560-612``). Returns ``(ses, out8,
    weights, g_sigma, (gc0, gc1, gc2), dz)``: ``ses`` is ``(se,)`` or
    ``(se_fine, se_coarse)``, ``out8`` the (fine) composited rows (R, 8),
    ``weights`` the compositing weights (R, S) and ``dz`` the composite's
    own z cotangent (both None in the dual mode); the cotangents of sigma
    and of the raw rgb are (R, S) f32, those of the sum of the SEs times
    ``scale``."""
    rgb = rgb.view(R, S, 8)
    sigma = fused_mlp.softplus(sig_pre)
    c0, c1, c2 = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    lane8 = torch.arange(8, device=z.device)[None, :]

    def loss_terms(out8):
        diff = torch.where(lane8 < 3, out8 - gt8, torch.zeros_like(out8))
        return (diff * diff).sum(), (2.0 * scale) * diff

    if coarse_mask is None:
        out8, aux = fused_mlp.composite_fwd_in_kernel(sigma, c0, c1, c2, z,
                                                      white_bg)
        se, g8 = loss_terms(out8)
        g_sigma, gc0, gc1, gc2, dz = fused_mlp.composite_bwd_in_kernel(
            sigma, c0, c1, c2, z, g8, aux, white_bg)
        return (se,), out8, aux[4], g_sigma, (gc0, gc1, gc2), dz
    out8, out8_c, aux = fused_mlp.composite_fwd_dual_in_kernel(
        sigma, c0, c1, c2, z, coarse_delta.float(), coarse_mask.float(),
        white_bg)
    se, g8 = loss_terms(out8)
    se_c, g8_c = loss_terms(out8_c)
    g_sigma, gc0, gc1, gc2 = fused_mlp.composite_bwd_dual_in_kernel(
        c0, c1, c2, z, g8, g8_c, aux, white_bg)
    return (se, se_c), out8, None, g_sigma, (gc0, gc1, gc2), None


def weight_grads_plain(pairs):
    """``[(dW, db), ...]`` for ``pairs`` of a layer's bf16 input ``x``
    (P, M) and output cotangent ``gh`` (P, N): ``dW = x^T @ gh`` (M, N) and
    ``db = Σ gh`` (N,), f32 sums of exact bf16 products — the TPU kernel's
    dW/db accumulators (``_tile_backward``'s ``acc``,
    ``codenerf_tpu/ops/fused_train.py:297-302``). The plain version of
    :func:`weight_grads`."""
    return [(x.float().T @ gh.float(), gh.float().sum(0)) for x, gh in pairs]


def weight_grads(pairs):
    """:func:`weight_grads_plain` by the CUDA kernel ``fused_step`` runs for
    the trunk in training (``wgrad_kernel``, one launch for every pair,
    then ``fixed_sum_kernel``), for its check against the plain version on
    the card: dW and db the same bits on every call. CUDA tensors only;
    each (M, N) one of (256, 256), (256, 128), (64, 256), all pairs over
    the same points. Counts its launches in ``weight_grads.launches``."""
    dev = pairs[0][0].device
    if dev.type != "cuda":
        raise ValueError("weight_grads launches the CUDA kernel on CUDA "
                         "tensors; weight_grads_plain is its plain version")
    xs = [_aligned(x, torch.bfloat16) for x, _ in pairs]
    gs = [_aligned(g, torch.bfloat16) for _, g in pairs]
    P = xs[0].shape[0]
    for x, g in zip(xs, gs):
        if (x.dim() != 2 or g.dim() != 2 or x.shape[0] != P
                or g.shape[0] != P or x.device != dev or g.device != dev):
            raise ValueError(f"weight_grads: pairs must be (P, M), (P, N) on "
                             f"{dev}; got {tuple(x.shape)}, {tuple(g.shape)}")
    lib = library()
    n = len(pairs)
    ms = (ctypes.c_int * n)(*[x.shape[1] for x in xs])
    ns = (ctypes.c_int * n)(*[g.shape[1] for g in gs])
    elems = lib.weight_grads_workspace(ms, ns, n, P)
    if elems == 0:
        raise ValueError("weight_grads takes 1-16 pairs of (M, N) in "
                         "(256, 256), (256, 128), (64, 256)")
    part = torch.empty(elems, dtype=torch.float32, device=dev)
    dws = [torch.empty(x.shape[1], g.shape[1], dtype=torch.float32,
                       device=dev) for x, g in zip(xs, gs)]
    dbs = [torch.empty(g.shape[1], dtype=torch.float32, device=dev)
           for g in gs]
    (xp, _kx), (gp, _kg) = _ptr_array(xs), _ptr_array(gs)
    (wp, _kw), (bp, _kb) = _ptr_array(dws), _ptr_array(dbs)
    rc = lib.weight_grads_step(
        xp, gp, ms, ns, n, P, wp, bp, _ptr(part),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"weight_grads CUDA kernel failed: cudaError {rc}")
    weight_grads.launches += 1
    return list(zip(dws, dbs))


weight_grads.launches = 0


# The dx kernel's warp slices, which fix the order of the per-ray
# code-cotangent sums (``ray_sums`` in csrc/train_fused.cu).
_SLICE_ROWS = 16


def slice_rows(R: int, S: int) -> int:
    """Rows of the dx kernel's slice span: one per 16-point slice."""
    return -(-R * S // _SLICE_ROWS)


def _ladder(v: torch.Tensor) -> torch.Tensor:
    """A warp's shuffle ladder over its 16 rows (n, 16, C) -> (n, C): rows
    k and k + 8 first, then a pairwise tree over k = 0..7 (f32 addition
    commutes, so each pair's order does not matter)."""
    u = v[:, :8] + v[:, 8:]
    u = u[:, 0::2] + u[:, 1::2]
    u = u[:, 0::2] + u[:, 1::2]
    return u[:, 0] + u[:, 1]


def ray_sums_plain(g: torch.Tensor, R: int, S: int):
    """The first stage of the per-ray sums of ``g`` (R·S, C) f32, point
    ``p`` of ray ``p // S``, as ``trunk_dx_kernel``'s ``ray_sums`` forms
    them: per 16-row warp slice, the ladder sum of each ray it touches.
    Returns ``(rays (R, C), slices (slice_rows(R, S), C))``: ``rays[r]``
    the partial of ray ``r`` over the slice where it starts (its whole
    sum if it ends there too), ``slices[s]`` the partial over slice ``s``
    of the ray that started before it. Entries no ray writes are NaN, so
    a reader of one shows."""
    P, C = g.shape
    dev, nan = g.device, float("nan")
    n_sl = slice_rows(R, S)
    rows = torch.arange(n_sl * _SLICE_ROWS, device=dev)
    ray_of = torch.where(rows < P, rows // S, -1).view(n_sl, _SLICE_ROWS)
    gp = torch.zeros(n_sl * _SLICE_ROWS, C, dtype=g.dtype, device=dev)
    gp[:P] = g
    gp = gp.view(n_sl, _SLICE_ROWS, C)
    sl0 = torch.arange(n_sl, device=dev) * _SLICE_ROWS
    first = sl0 // S
    last = torch.clamp(sl0 + _SLICE_ROWS - 1, max=P - 1) // S
    rays = torch.full((R, C), nan, dtype=g.dtype, device=dev)
    slices = torch.full((n_sl, C), nan, dtype=g.dtype, device=dev)
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    for k in range((_SLICE_ROWS - 1) // S + 2):     # rays a slice touches
        ray = first + k
        on = ray <= last
        s = _ladder(torch.where((ray_of == ray[:, None])[..., None], gp,
                                zero))
        starts = on & (ray * S >= sl0)
        rays[ray[starts]] = s[starts]
        before = on & ~starts
        slices[before] = s[before]
    return rays, slices


def fold_ray_sums_f32(rays: torch.Tensor, slices: torch.Tensor, R: int,
                      S: int) -> torch.Tensor:
    """The second stage, in f32: each ray's sum (R, C), ``rays[r]`` plus
    the row of each later slice the ray touches, left to right
    (``ray_sum_fold_kernel``'s order)."""
    dev = rays.device
    r0 = torch.arange(R, device=dev) * S
    s0, s1 = r0 // _SLICE_ROWS, (r0 + S - 1) // _SLICE_ROWS
    acc = rays
    for d in range(1, (S - 1) // _SLICE_ROWS + 2):
        on = (s0 + d <= s1)[:, None]
        acc = torch.where(on, acc + slices[torch.clamp(
            s0 + d, max=slices.shape[0] - 1)], acc)
    return acc


def _sections(x: torch.Tensor, rows: int, nb: int, nt: int, W: int):
    """A flat s | t | v span of ``rows`` rows -> (rows, (nb + nt + 1)·W),
    each row the s, t and v values of one ray or tile row."""
    n_s, n_t = rows * nb * W, rows * nt * W
    return torch.cat([x[:n_s].view(rows, nb * W),
                      x[n_s:n_s + n_t].view(rows, nt * W),
                      x[n_s + n_t:].view(rows, W)], dim=1)


def fold_ray_sums_plain(x, sl, R: int, S: int, nb: int, nt: int, W: int):
    """The code cotangents' last pass in plain PyTorch: ``x`` the rays'
    f32 span (R·(nb + nt + 1)·W, laid out ``s (R, nb, W) | t (R, nt, W)
    | v (R, W)``) and ``sl`` the slices' span (the same layout with
    :func:`slice_rows` rows), as ``trunk_dx_kernel`` leaves them, added by
    :func:`fold_ray_sums_f32` and rounded to nearest even into
    ``(d_sproj (R, nb, W), d_tproj (R, nt, W), d_vcontrib (R, W))`` bf16
    — the TPU kernels' ``h.ray_sum(g).astype(bf16)``
    (``codenerf_tpu/ops/fused_train.py:321,323,345``)."""
    y = fold_ray_sums_f32(_sections(x, R, nb, nt, W),
                          _sections(sl, slice_rows(R, S), nb, nt, W), R,
                          S).to(torch.bfloat16)
    return (y[:, :nb * W].reshape(R, nb, W),
            y[:, nb * W:(nb + nt) * W].reshape(R, nt, W),
            y[:, (nb + nt) * W:].contiguous())


def fold_ray_sums(x, sl, R: int, S: int, nb: int, nt: int, W: int):
    """:func:`fold_ray_sums_plain` by the CUDA kernel that ``fused_step``
    runs last in every mode (``ray_sum_fold_kernel``, one launch for the
    three outputs), for its check against the plain version on the card:
    the same bits. CUDA tensors only: ``x`` (R·(nb + nt + 1)·W,) and
    ``sl`` (slice_rows(R, S)·(nb + nt + 1)·W,) f32, contiguous and 16-byte
    aligned; R, S, nb, nt >= 1 and W a multiple of 8. Counts its launches
    in ``fold_ray_sums.launches``."""
    if R < 1 or S < 1 or nb < 1 or nt < 1 or W < 8 or W % 8:
        raise ValueError(f"fold_ray_sums takes R, S, nb, nt >= 1 and W a "
                         f"multiple of 8; got R={R}, S={S}, nb={nb}, "
                         f"nt={nt}, W={W}")
    C = (nb + nt + 1) * W
    dev = fused_mlp._check_operands("fold_ray_sums", [
        ("x", x, torch.float32, (R * C,)),
        ("sl", sl, torch.float32, (slice_rows(R, S) * C,))])
    outs = [torch.empty(R, k, W, dtype=torch.bfloat16, device=dev)
            for k in (nb, nt)] + [torch.empty(R, W, dtype=torch.bfloat16,
                                              device=dev)]
    rc = library().ray_sum_fold_step(
        *[_ptr(t) for t in (x, sl, *outs)], R, S, nb, nt, W,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"fold_ray_sums CUDA kernel failed: cudaError "
                           f"{rc}")
    fold_ray_sums.launches += 1
    return tuple(outs)


fold_ray_sums.launches = 0


def backward_chain_plain(cfg: NetConfig, R: int, S: int, acts, sproj, tproj,
                         wops, g_sigma, g_rgb, weight_grads: bool,
                         input_grads: bool, sigma_terms=None, pairs=None):
    """The dx chain (and with ``weight_grads`` the dW/db of every layer)
    from the per-sample cotangents of sigma ``g_sigma`` (R, S) and of the
    raw rgb ``g_rgb`` (three (R, S) planes), over the activations of
    :func:`fused_mlp.forward_plain` — the TPU kernels' ``_tile_backward``.
    Returns ``(d_sproj, d_tproj, d_vcontrib, gh0, dwb)``: ``gh0`` is
    enc_xyz's bf16 output cotangent (with ``weight_grads`` or
    ``input_grads``, else None) and ``dwb`` the f32 gradients in
    :func:`weight_shapes` order (empty without ``weight_grads``).
    ``pairs``, a list, receives ``(name, x, gh)`` of every layer whose
    dW/db :func:`weight_grads_plain` forms (with ``weight_grads``)."""
    f32, bf16 = torch.float32, torch.bfloat16
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    P, dev = R * S, g_sigma.device
    idx = {n: j for j, (n, _, _) in enumerate(weight_shapes(cfg))}

    def w(name):
        return wops[2 * idx[name]]

    def dot_t(g, wm):    # (P, B) bf16 @ (A, B)^T -> (P, A) f32
        return g.float() @ wm.float().T

    def ray_sum(x):
        return x.view(R, S, -1).sum(dim=1)

    dwb = {}

    def acc(name, x, gh):   # dW = x^T @ gh, db = Σ gh, f32
        if weight_grads:
            (dwb[name],) = weight_grads_plain([(x, gh)])
            if pairs is not None:
                pairs.append((name, x, gh))

    pe, y0, xs, ys, t = (acts[k] for k in ("pe", "y0", "xs", "ys", "t"))
    yv, xts, yts, r = (acts[k] for k in ("yv", "xts", "yts", "r"))
    gh8 = torch.zeros(R, S, 8, dtype=f32, device=dev)
    for k in range(3):
        gh8[..., k] = g_rgb[k]
    gh8 = gh8.view(P, 8).to(bf16)
    acc("rgb_out", r, gh8)
    gr = dot_t(gh8, w("rgb_out"))
    gh = (gr * (r.float() > 0)).to(bf16)
    acc("rgb_hidden", yts[-1], gh)
    g_cur = dot_t(gh, w("rgb_hidden"))
    d_tproj = torch.empty(R, nt, W, dtype=bf16, device=dev)
    for j in reversed(range(nt)):
        gh = (g_cur * (yts[j].float() > 0)).to(bf16)
        acc(f"texture_{j}", xts[j], gh)
        g_cur = dot_t(gh, w(f"texture_{j}"))
        d_tproj[:, j] = ray_sum(g_cur).to(bf16)
    gu = g_cur * (yv.float() > 0)
    d_vcontrib = ray_sum(gu).to(bf16)
    gu16 = gu.to(bf16)
    acc("enc_viewdir_pt", t, gu16)
    g_t = dot_t(gu16, w("enc_viewdir_pt"))
    w_sig = w("sigma")
    dsig = g_sigma.float() * torch.sigmoid(acts["sig_pre"])
    g_t = (g_t.view(R, S, W) + dsig[:, :, None] * w_sig[None, None, :]
           ).view(P, W)
    if weight_grads:
        t_dsig = t.float().view(R, S, W) * dsig[:, :, None]
        dwb["sigma"] = (t_dsig.sum((0, 1)), dsig.sum().reshape(1))
        if sigma_terms is not None:
            sigma_terms += [t_dsig.abs().sum((0, 1)),
                            dsig.abs().sum().reshape(1)]
    gh = g_t.to(bf16)
    acc("enc_shape", ys[-1], gh)
    g_cur = dot_t(gh, w("enc_shape"))
    d_sproj = torch.empty(R, nb, W, dtype=bf16, device=dev)
    for j in reversed(range(nb)):
        gh = (g_cur * (ys[j].float() > 0)).to(bf16)
        acc(f"shape_{j}", xs[j], gh)
        g_cur = dot_t(gh, w(f"shape_{j}"))
        d_sproj[:, j] = ray_sum(g_cur).to(bf16)
    gh0 = None
    if weight_grads or input_grads:
        gh0 = (g_cur * (y0.float() > 0)).to(bf16)
        acc("enc_xyz", pe, gh0)
    flat = [x for name, _, _ in (weight_shapes(cfg) if weight_grads else ())
            for x in dwb[name]]
    return d_sproj, d_tproj, d_vcontrib, gh0, flat


# ---------------------------------------------------------------- plane op

def fused_train_available(cfg: NetConfig, n_rays: int,
                          n_samples: int) -> bool:
    """Counterpart of ``fused_train.fused_train_available``: the plane-op
    pair can tile this problem — the single-pass rule and the TPU forward
    kernel's 32-ray tile (``fused_mlp._TILE_RAYS``). The CUDA kernels do
    not tile by 32; the rule keeps both packages on the same routes.
    ``n_samples`` is unconstrained, as on the TPU."""
    del n_samples
    return (single_pass_available(cfg, n_rays)
            and n_rays % max(_TRAIN_TILE_RAYS, fused_mlp._TILE_RAYS) == 0)


def _plane_mode(weight_grads: bool, input_grads: bool) -> str:
    if weight_grads:
        return "plane_train_input" if input_grads else "plane_train"
    return "plane_pose" if input_grads else "plane_codes"


def plane_bwd(cfg: NetConfig, S: int, R: int, ro8, vd8, z, sproj, tproj,
              vcontrib, weights, g_planes, weight_grads: bool = True,
              input_grads: bool = True):
    """Counterpart of ``_invoke_bwd``, the plane op's backward: recompute
    the forward, then chain the outside cotangents ``g_planes`` — four
    (R, S) f32 planes for sigma, r, g, b, as :func:`fused_mlp.planes_fwd`
    returns them — down the network. Returns, in the TPU kernel's order,
    ``[d_ro8 (R, 8), d_vd8 (R, 8), d_z (R, S)] f32`` (with
    ``input_grads``: the PE Jacobian chain alone; the composite's z term
    reaches z outside), ``d_sproj (R, nb, W), d_tproj (R, nt, W),
    d_vcontrib (R, W)`` bf16, ``[dW_0, db_0, ...]`` f32 (with
    ``weight_grads``). All four flag pairs run. ``weights`` as for
    :func:`train_fused`.

    On CPU tensors this is :func:`plane_bwd_plain`; on CUDA tensors it
    launches ``fused_step`` of ``csrc/train_fused.cu`` with the planes
    in place of the composite (the same workspace, trunk kernels, chains
    and input-chain kernel as :func:`train_fused`) and counts the launch
    in ``plane_bwd.launches`` (its R·S in ``plane_bwd.points``):
    ``plane_train`` (weight gradients), ``plane_codes`` (neither),
    ``plane_pose`` (input gradients), ``plane_train_input`` (both)."""
    if z.shape != (R, S):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {(R, S)}")
    if z.device.type == "cpu":
        return plane_bwd_plain(cfg, S, R, ro8, vd8, z, sproj, tproj,
                               vcontrib, weights, g_planes, weight_grads,
                               input_grads)
    if z.device.type != "cuda":
        raise ValueError(f"plane_bwd: unsupported device {z.device}")
    outs = _launch_cuda(cfg, S, R, True, 1.0, ro8, vd8, z, sproj, tproj,
                        vcontrib, None, weights, False, False, weight_grads,
                        input_grads, None, None, g_planes=g_planes)
    mode = _plane_mode(weight_grads, input_grads)
    plane_bwd.launches[mode] += 1
    plane_bwd.points[mode] += R * S
    plane_bwd.bulk_planes[mode] += library().forward_bulk_planes()
    return outs


plane_bwd.launches = {"plane_train": 0, "plane_codes": 0, "plane_pose": 0,
                      "plane_train_input": 0}
plane_bwd.points = dict(plane_bwd.launches)
plane_bwd.bulk_planes = dict(plane_bwd.launches)


def plane_bwd_plain(cfg: NetConfig, S: int, R: int, ro8, vd8, z, sproj,
                    tproj, vcontrib, wflat, g_planes,
                    weight_grads: bool = True, input_grads: bool = True,
                    sigma_terms=None):
    """:func:`plane_bwd` in plain PyTorch: :func:`fused_mlp.forward_plain`,
    then :func:`backward_chain_plain` from the four planes (the rgb
    cotangents rounded to bf16 there, as the TPU kernel rounds its g8
    lanes), then :func:`fused_mlp.input_chain_plain` with no composite
    term."""
    wops = kernel_operands(wflat)
    z = z.float()
    acts = fused_mlp.forward_plain(cfg, R, S, ro8, vd8, z, sproj, tproj,
                                   vcontrib, wops)
    gsig, gr, gg, gb = (g.float() for g in g_planes)
    d_sproj, d_tproj, d_vcontrib, gh0, dwb = backward_chain_plain(
        cfg, R, S, acts, sproj, tproj, wops, gsig, (gr, gg, gb),
        weight_grads, input_grads, sigma_terms)
    outs = ()
    if input_grads:
        outs = fused_mlp.input_chain_plain(R, S, ro8, vd8, z, gh0, wops[0],
                                           torch.zeros_like(z),
                                           cfg.num_xyz_freq)
    return outs + (d_sproj, d_tproj, d_vcontrib) + tuple(dwb)


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _ptr_array(xs) -> ctypes.c_void_p:
    arr = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _aligned(x: torch.Tensor, dtype) -> torch.Tensor:
    """Contiguous, of ``dtype``, 16-byte aligned (the kernel loads 16 B)."""
    x = x.to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bind(lib: ctypes.CDLL):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_step.argtypes = ([vp] * 24 + [ci] * 8
                               + [ctypes.c_float, ci, vp])
    lib.fused_step.restype = ci
    lib.fused_workspace.argtypes = [ci] * 7 + [vp, vp]
    lib.fused_workspace.restype = None
    lib.sigma_step.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.sigma_step.restype = ci
    lib.forward_workspace.argtypes = [ci] * 6
    lib.forward_workspace.restype = ctypes.c_size_t
    lib.pack_trunk_weights.argtypes = [vp, ci, ci, ci, vp, vp]
    lib.pack_trunk_weights.restype = ci
    lib.packed_trunk_elems.argtypes = [ci] * 3
    lib.packed_trunk_elems.restype = ctypes.c_size_t
    lib.planes_step.argtypes = [vp] * 13 + [ci] * 6 + [vp]
    lib.planes_step.restype = ci
    lib.composite_fwd.argtypes = [vp] * 6 + [ci] * 3 + [vp]
    lib.composite_fwd.restype = ci
    lib.composite_bwd.argtypes = [vp] * 11 + [ci] * 3 + [vp]
    lib.composite_bwd.restype = ci
    lib.weight_grads_workspace.argtypes = [vp, vp, ci, ci]
    lib.weight_grads_workspace.restype = ctypes.c_size_t
    lib.weight_grads_step.argtypes = [vp] * 4 + [ci] * 2 + [vp] * 4
    lib.weight_grads_step.restype = ci
    lib.input_chain_step.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.input_chain_step.restype = ci
    lib.plane_head_step.argtypes = [vp] * 10 + [ci] * 3 + [vp]
    lib.plane_head_step.restype = ci
    lib.sigma_head_step.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.sigma_head_step.restype = ci
    lib.ray_sum_fold_step.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.ray_sum_fold_step.restype = ci
    lib.forward_bulk_planes.argtypes = []
    lib.forward_bulk_planes.restype = ci


def library() -> ctypes.CDLL:
    """``csrc/train_fused.cu`` built (at first use), loaded and bound: the
    single-pass kernel's and the plane-op backward's ``fused_step``, the
    forwards ``sigma_step`` and ``planes_step``, the standalone
    composite's ``composite_fwd`` and ``composite_bwd``, the weight
    packer ``pack_trunk_weights`` (the only launcher of ``pack_kernel``)
    and, each alone for its check, the
    weight-gradient kernel ``weight_grads_step``, the input chain
    ``input_chain_step``, the four-plane head ``plane_head_step``, the
    sigma-only head ``sigma_head_step`` and the code cotangents' last
    pass ``ray_sum_fold_step``."""
    from codenerf_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    if not getattr(lib, "_bound", False):
        _bind(lib)
        lib._bound = True
    return lib


def checked_weights(cfg: NetConfig, wflat, dev) -> List[torch.Tensor]:
    """The kernel operands of ``wflat``, 16-byte aligned, each checked
    against :func:`weight_shapes` and the device."""
    wops = [_aligned(w, w.dtype) for w in kernel_operands(wflat)]
    for w_, (name, ws, _) in zip(wops[0::2], weight_shapes(cfg)):
        if tuple(w_.shape) != ws or w_.device != dev:
            raise ValueError(f"weight {name} is {tuple(w_.shape)} on "
                             f"{w_.device}, expected {ws} on {dev}")
    return wops


def _launch_cuda(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj, tproj,
                 vcontrib, gt8, weights, want_weights, want_rgb, weight_grads,
                 input_grads, coarse_mask, coarse_delta, g_planes=None):
    """One ``fused_step`` launch on the packed operands of ``weights``,
    a :class:`TrunkOperands`. With ``g_planes`` (the plane-op
    backward; ``gt8`` None) it returns :func:`plane_bwd`'s outputs, else
    :func:`train_fused`'s."""
    lib = library()
    dev = z.device
    f32, bf16 = torch.float32, torch.bfloat16
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    dual = coarse_mask is not None
    planes = g_planes is not None
    what = "plane_bwd" if planes else "train_fused"
    if S > _MAX_SAMPLES or W != TRUNK_W or not single_pass_available(cfg,
                                                                     R):
        raise ValueError(f"{what}: the CUDA kernels take S <= "
                         f"{_MAX_SAMPLES}, W == {TRUNK_W}, d_xyz <= 64 and "
                         f"R % 16 == 0; got S={S}, W={W}, R={R}")
    ins = dict(ro8=_aligned(ro8, f32), vd8=_aligned(vd8, f32),
               z=_aligned(z, f32), sproj=_aligned(sproj, bf16),
               tproj=_aligned(tproj, bf16), vcontrib=_aligned(vcontrib, bf16))
    expect = dict(ro8=(R, 8), vd8=(R, 8), z=(R, S), sproj=(R, nb, W),
                  tproj=(R, nt, W), vcontrib=(R, W))
    if planes:
        for k, g in zip(("gsig", "gr", "gg", "gb"), g_planes):
            ins[k] = _aligned(g, f32)
            expect[k] = (R, S)
    else:
        ins["gt8"] = _aligned(gt8, f32)
        expect["gt8"] = (R, 8)
    if dual:
        ins.update(cmask=_aligned(coarse_mask, f32),
                   cdelta=_aligned(coarse_delta, f32))
        expect.update(cmask=(R, S), cdelta=(R, S))
    for name, x in ins.items():
        if tuple(x.shape) != expect[name] or x.device != dev:
            raise ValueError(f"{what}: {name} is {tuple(x.shape)} on "
                             f"{x.device}, expected {expect[name]} on {dev}")
    wops, packed = _cuda_trunk(cfg, weights, dev)
    n_bf16, n_f32 = ctypes.c_size_t(), ctypes.c_size_t()
    lib.fused_workspace(R, S, W, nb, nt, int(weight_grads), int(input_grads),
                        ctypes.addressof(n_bf16), ctypes.addressof(n_f32))
    ws = torch.empty(n_bf16.value, dtype=bf16, device=dev)
    ws32 = torch.empty(n_f32.value, dtype=f32, device=dev)
    se8 = None if planes else torch.empty(R, 8, dtype=f32, device=dev)

    def opt_out(on, *shape):
        return torch.empty(*shape, dtype=f32, device=dev) if on else None

    weights = opt_out(want_weights, R, S)
    rgb8 = opt_out(want_rgb, R, 8)
    d_ro8, d_vd8 = opt_out(input_grads, R, 8), opt_out(input_grads, R, 8)
    d_z = opt_out(input_grads, R, S)
    d_sproj = torch.empty(R, nb, W, dtype=bf16, device=dev)
    d_tproj = torch.empty(R, nt, W, dtype=bf16, device=dev)
    d_vcontrib = torch.empty(R, W, dtype=bf16, device=dev)
    dwb = []
    if weight_grads:
        for _, ws_, bs_ in weight_shapes(cfg):
            dwb += [torch.empty(ws_, dtype=f32, device=dev),
                    torch.empty(bs_, dtype=f32, device=dev)]
    wptrs, _keep_w = _ptr_array(wops)
    dptrs, _keep_d = (_ptr_array(dwb) if weight_grads
                      else (ctypes.c_void_p(0), None))

    def opt_ptr(x):
        return ctypes.c_void_p(0) if x is None else _ptr(x)

    gptrs, _keep_g = (_ptr_array([ins[k] for k in ("gsig", "gr", "gg",
                                                    "gb")])
                      if planes else (ctypes.c_void_p(0), None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_step(
        _ptr(ins["ro8"]), _ptr(ins["vd8"]), _ptr(ins["z"]),
        _ptr(ins["sproj"]), _ptr(ins["tproj"]), _ptr(ins["vcontrib"]),
        opt_ptr(ins.get("gt8")), opt_ptr(ins.get("cmask")),
        opt_ptr(ins.get("cdelta")), gptrs, wptrs, _ptr(packed), _ptr(ws),
        _ptr(ws32), opt_ptr(se8), opt_ptr(rgb8), opt_ptr(weights),
        _ptr(d_sproj), _ptr(d_tproj), _ptr(d_vcontrib), opt_ptr(d_ro8),
        opt_ptr(d_vd8), opt_ptr(d_z), dptrs, int(bool(weight_grads)),
        int(bool(input_grads)),
        R, S, W, nb, nt, cfg.num_xyz_freq, ctypes.c_float(2.0 * scale),
        int(bool(white_bg)), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{what} CUDA kernel failed: cudaError {rc}")
    if planes:
        outs = (d_ro8, d_vd8, d_z) if input_grads else ()
        return outs + (d_sproj, d_tproj, d_vcontrib) + tuple(dwb)
    # the fine SE in lanes 0..2, the dual mode's coarse SE in lanes 4..6
    ses = ((se8[:, :4].sum(), se8[:, 4:].sum()) if dual else (se8.sum(),))
    outs = ses + (d_sproj, d_tproj, d_vcontrib)
    outs += tuple(x for x in (weights, rgb8) if x is not None)
    if input_grads:
        outs += (d_ro8, d_vd8, d_z)
    return outs + tuple(dwb)


class FusedCodesLoss(torch.autograd.Function):
    """``scale · Σ squared error`` of one chunk under a frozen model,
    differentiable with respect to the per-ray operands ``(sproj, tproj,
    vcontrib)``: the kernel (``weight_grads=False``) computes the loss and
    its cotangents in one pass, and the backward hands those cotangents on
    (times the incoming gradient). Returns ``(loss, fine, rgb8)``:
    ``fine`` and the composited ``rgb8`` rows (empty unless ``want_rgb``)
    carry no gradient. With ``coarse_mask`` and ``coarse_delta`` (the dual
    mode) the loss is ``scale · (se_fine + se_coarse)``, ``fine`` is
    ``scale · se_fine`` (the reported MSE) and ``rgb8`` holds the fine
    composite's rows; otherwise ``fine`` equals the loss. ``weights`` as
    for :func:`train_fused`."""

    @staticmethod
    def forward(ctx, sproj, tproj, vcontrib, cfg, white_bg, scale, ro8,
                vd8, z, gt8, weights, want_rgb, coarse_mask=None,
                coarse_delta=None):
        R, S = z.shape
        outs = train_fused(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                           tproj, vcontrib, gt8, weights, want_rgb=want_rgb,
                           weight_grads=False, coarse_mask=coarse_mask,
                           coarse_delta=coarse_delta)
        n_se = 1 if coarse_mask is None else 2
        d_sproj, d_tproj, d_vcontrib = outs[n_se:n_se + 3]
        rgb8 = outs[n_se + 3] if want_rgb else z.new_empty(0, 8)
        ctx.save_for_backward(d_sproj, d_tproj, d_vcontrib)
        fine = (outs[0] * scale).detach()
        ctx.mark_non_differentiable(fine, rgb8)
        return sum(outs[:n_se]) * scale, fine, rgb8

    @staticmethod
    def backward(ctx, g_loss, g_fine, g_rgb8):
        d_sproj, d_tproj, d_vcontrib = ctx.saved_tensors
        return ((d_sproj * g_loss, d_tproj * g_loss, d_vcontrib * g_loss)
                + (None,) * 11)


class FusedPoseLoss(torch.autograd.Function):
    """``scale · Σ squared error`` of one ray batch under a frozen model,
    differentiable with respect to the rays, the depths and the per-ray
    operands ``(ro8, vd8, z, sproj, tproj, vcontrib)``: the kernel's pose
    modes (``weight_grads=False, input_grads=True``) compute the loss and
    all six cotangents in one pass, and the backward hands them on (times
    the incoming gradient), so autograd chains them through the prologue,
    the depth sampling and ray generation into the pose. Returns ``(loss,
    fine, weights)``: ``fine`` equals the loss and carries no gradient;
    ``weights`` (R, S), the compositing weights, only with
    ``want_weights`` (else empty), carries none either. ``weights`` as
    for :func:`train_fused`."""

    @staticmethod
    def forward(ctx, ro8, vd8, z, sproj, tproj, vcontrib, cfg, white_bg,
                scale, gt8, weights, want_weights):
        R, S = z.shape
        outs = train_fused(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                           tproj, vcontrib, gt8, weights,
                           want_weights=want_weights, weight_grads=False,
                           input_grads=True)
        d_sproj, d_tproj, d_vcontrib = outs[1:4]
        weights = outs[4] if want_weights else z.new_empty(0, S)
        d_ro8, d_vd8, d_z = outs[-3:]
        ctx.save_for_backward(d_ro8, d_vd8, d_z, d_sproj, d_tproj,
                              d_vcontrib)
        fine = (outs[0] * scale).detach()
        ctx.mark_non_differentiable(fine, weights)
        return outs[0] * scale, fine, weights

    @staticmethod
    def backward(ctx, g_loss, g_fine, g_weights):
        return (tuple(x * g_loss for x in ctx.saved_tensors)
                + (None,) * 6)


class FusedTrainLoss(torch.autograd.Function):
    """``scale · Σ squared error`` of one batch, differentiable with
    respect to the per-ray operands and every weight operand:
    ``apply(static, sproj, tproj, vcontrib, *wflat)`` with ``static =
    (cfg, white_bg, scale, ro8, vd8, z, gt8, coarse_mask, coarse_delta,
    trunk)`` (the dual mode's planes None outside it) and ``wflat`` the
    f32 operands of :func:`flatten_params`, through which the dW/db flow
    back. The kernels read ``trunk``, the :func:`trunk_operands` of the
    same weights, and ``wflat`` only carries the gradients. The kernel (``weight_grads=True``) computes the loss, the
    per-ray cotangents and every dW/db in one pass; the backward hands
    them on times the incoming gradient, and autograd chains them through
    the prologue into the model and the codes. Returns ``(loss, fine)``: with the dual mode's
    ``coarse_mask`` and ``coarse_delta`` the loss is ``scale · (se_fine +
    se_coarse)`` and ``fine`` (no gradient) is ``scale · se_fine``, the
    logged MSE; otherwise both are ``scale · se``."""

    @staticmethod
    def forward(ctx, static, sproj, tproj, vcontrib, *wflat):
        cfg, white_bg, scale, ro8, vd8, z, gt8, cmask, cdelta, trunk = static
        R, S = z.shape
        outs = train_fused(cfg, S, R, white_bg, scale, ro8, vd8, z, sproj,
                           tproj, vcontrib, gt8, trunk,
                           weight_grads=True, coarse_mask=cmask,
                           coarse_delta=cdelta)
        n_se = 1 if cmask is None else 2
        ctx.save_for_backward(*outs[n_se:])
        fine = (outs[0] * scale).detach()
        ctx.mark_non_differentiable(fine)
        return sum(outs[:n_se]) * scale, fine

    @staticmethod
    def backward(ctx, g_loss, g_fine):
        return (None,) + tuple(x * g_loss for x in ctx.saved_tensors)


class PlaneOp(torch.autograd.Function):
    """The plane op (the JAX package's ``_make_plane_op`` custom VJP):
    ``apply(mode, ro8, vd8, z, sproj, tproj, vcontrib, *wflat) -> (sigma,
    r, g, b)``, four (R, S) f32 planes from :func:`fused_mlp.planes_fwd`;
    ``mode = (cfg, weight_grads, input_grads, trunk)``. Both passes read
    ``trunk``, the :func:`trunk_operands` of the network, and ``wflat``
    (:func:`flatten_params`, none at all in a frozen mode) only carries
    the weight gradients; with ``trunk`` None (CPU tensors only) they
    read ``wflat``. The forward keeps only its
    operands; the backward is :func:`plane_bwd`, which recomputes the
    forward and returns the cotangents the mode asks for — the others are
    None (zero), as the JAX op's zeros."""

    @staticmethod
    def forward(ctx, mode, ro8, vd8, z, sproj, tproj, vcontrib, *wflat):
        cfg, trunk = mode[0], mode[3]
        R, S = z.shape
        ctx.mode = mode
        ctx.save_for_backward(ro8, vd8, z, sproj, tproj, vcontrib, *wflat)
        return fused_mlp.planes_fwd(cfg, S, R, ro8, vd8, z, sproj, tproj,
                                    vcontrib,
                                    list(wflat) if trunk is None else trunk)

    @staticmethod
    def backward(ctx, *g_planes):
        cfg, weight_grads, input_grads, trunk = ctx.mode
        ro8, vd8, z, sproj, tproj, vcontrib, *wflat = ctx.saved_tensors
        R, S = z.shape
        outs = list(plane_bwd(cfg, S, R, ro8, vd8, z, sproj, tproj,
                              vcontrib, wflat if trunk is None else trunk,
                              g_planes, weight_grads, input_grads))
        d_in = [None] * 3
        if input_grads:
            d_in, outs = outs[:3], outs[3:]
        d_w = outs[3:] if weight_grads else [None] * len(wflat)
        return (None, *d_in, *outs[:3], *d_w)


def _make_plane_op(cfg: NetConfig, weight_grads: bool, input_grads: bool):
    """``op(ro8, vd8, z, sproj, tproj, vcontrib, *wflat, trunk=None) ->
    (sigma, r, g, b)``: :class:`PlaneOp` in one mode. ro8/vd8 (R, 8) f32,
    z (R, S) f32, sproj/tproj (R, blocks, W) and vcontrib (R, W) bf16,
    ``trunk`` the network's :func:`trunk_operands`, wflat the f32 operands
    of :func:`flatten_params` that carry the weight gradients (none for a
    mode without them; on CPU tensors, with no ``trunk``, the weights the
    op reads). ``op.weight_grads`` tells whether the op differentiates
    the weights."""

    def op(ro8, vd8, z, sproj, tproj, vcontrib, *wflat, trunk=None):
        return PlaneOp.apply((cfg, weight_grads, input_grads, trunk), ro8,
                             vd8, z, sproj, tproj, vcontrib, *wflat)

    op.weight_grads = weight_grads
    return op


def make_fused_train_op(cfg: NetConfig, input_grads: bool = True):
    """The training plane op: every weight's gradient, and with
    ``input_grads`` (the default, as in JAX) the ray and depth cotangents
    too; a training step passes ``input_grads=False`` (its rays and depths
    are constants)."""
    return _make_plane_op(cfg, weight_grads=True, input_grads=input_grads)


def make_fused_codes_op(cfg: NetConfig):
    """The frozen-model plane op of code optimization: the code operands'
    cotangents alone."""
    return _make_plane_op(cfg, weight_grads=False, input_grads=False)


def make_fused_pose_op(cfg: NetConfig):
    """The frozen-model plane op of pose optimization: the codes' and the
    rays' and depths' cotangents."""
    return _make_plane_op(cfg, weight_grads=False, input_grads=True)


def _with_composite(plane_op, white_bg: bool):
    """A plane op chained into the standalone composite
    (``ops/composite.py``): ``op(...) -> (R, 8) f32 [r g b depth acc 0 0
    0]``, whose backward hands the composite's five plane cotangents (dz
    included) to the plane op's. Coarse paths only: hierarchical sampling
    needs the weights plane."""
    from codenerf_tpu_torch.ops.composite import composite_op

    def op(ro8, vd8, z, sproj, tproj, vcontrib, *wflat, trunk=None):
        sig, r, g, b = plane_op(ro8, vd8, z, sproj, tproj, vcontrib, *wflat,
                                trunk=trunk)
        return composite_op(sig, r, g, b, z, white_bg)

    op.weight_grads = plane_op.weight_grads
    return op


def make_fused_train_composite_op(cfg: NetConfig, white_bg: bool = True,
                                  input_grads: bool = True):
    """The training plane op chained into the standalone composite."""
    return _with_composite(make_fused_train_op(cfg, input_grads=input_grads),
                           white_bg)


def make_fused_codes_composite_op(cfg: NetConfig, white_bg: bool = True):
    """The codes plane op chained into the standalone composite: the
    coarse code-optimization route for chunks that need padding."""
    return _with_composite(make_fused_codes_op(cfg), white_bg)


def fused_apply_train(model, cfg: NetConfig, ray_o, viewdir, z_vals,
                      shape_code, texture_code, op=None):
    """The differentiable plane-op evaluation of ``model`` at rays (R, 3)
    and depths (R, S) with codes (R, D) or (D,): ``(sigmas, (r, g, b))``,
    (R, S) f32 planes for ``core.render.composite``. The per-ray prologue
    is plain PyTorch, so autograd reaches the weights, codes, rays and
    depths through it. ``op`` defaults to :func:`make_fused_train_op`.
    Both passes read ``model``'s cached :func:`trunk_operands`."""
    ro8, vd8, z, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
        model, cfg, ray_o, viewdir, z_vals, shape_code, texture_code)
    if op is None:
        op = make_fused_train_op(cfg)
    wflat, trunk = _op_weights(model, cfg, op)
    sigmas, r, g, b = op(ro8, vd8, z, sproj, tproj, vcontrib, *wflat,
                         trunk=trunk)
    return sigmas, (r, g, b)


def _op_weights(model, cfg: NetConfig, op):
    """``(wflat, trunk)`` of a plane op on ``model``: its cached
    :func:`trunk_operands`, and :func:`flatten_params` to carry the
    weight gradients where the op differentiates the weights (else
    none)."""
    return (flatten_params(model, cfg) if op.weight_grads else (),
            trunk_operands(model, cfg))


def fused_render_train(model, cfg: NetConfig, ray_o, viewdir, z_vals,
                       shape_code, texture_code, op=None,
                       white_bg: bool = True):
    """The plane op chained into the standalone composite, from rays,
    depths and codes: a ``core.render.RenderOutput`` whose rgb, depth and
    acc come from the composite kernel (``weights`` None). ``op``
    defaults to :func:`make_fused_train_composite_op`."""
    from codenerf_tpu_torch.core.render import RenderOutput

    ro8, vd8, z, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
        model, cfg, ray_o, viewdir, z_vals, shape_code, texture_code)
    if op is None:
        op = make_fused_train_composite_op(cfg, white_bg=white_bg)
    wflat, trunk = _op_weights(model, cfg, op)
    out8 = op(ro8, vd8, z, sproj, tproj, vcontrib, *wflat, trunk=trunk)
    return RenderOutput(rgb=out8[:, :3], depth=out8[:, 3], acc=out8[:, 4],
                        weights=None)
