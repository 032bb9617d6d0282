#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codenerf_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --check    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --main_paths   # phases 1-13 and 15

Phases, each printed on its own line with its seconds:

1. the card (``nvidia-smi`` name and power limit); build every CUDA kernel
   from ``codenerf_tpu_torch/ops/csrc`` (one ``nvcc`` per source, started
   together);
2. each kernel mode against its plain PyTorch version at the main paths'
   full width (W=256, 3 shape + 1 texture blocks, seeded inputs), with the
   tolerance stated in ``_close``: the frozen-model mode at the
   optimization chunk (R=4096) and the weight-gradient mode at the
   training batch (R=16,384), S=96, whose per-ray cotangents must also
   equal the frozen mode's on the same inputs; the sigma-only forward at
   R=16,384 and R=4096, S=32, and at NeRF's 16,384 × 64; the dual-composite
   mode at a real union of 32 coarse and 32 fine depths
   (``hier_fine_zvals_meta`` on seeded coarse depths), training at R=16,384
   (its per-ray cotangents equal to the dual frozen mode's on the same
   inputs, its fine SE to the non-dual frozen kernel's on the same union)
   and frozen at R=4096; the pose
   modes at pose optimization's 2048 rays: ``pose`` at S=96 and on a real
   32+32 union, ``pose_weights`` at S=32 (their SE and code cotangents
   equal to the frozen mode's on the same inputs, their ``d_ro8``,
   ``d_vd8`` and ``d_z`` the same bits over two launches); the
   four-plane forward at 16,384 × 64, at a 128×128 view's 16,384 × 96
   and at the fine pass of NeRF's 64 + 128 view, 16,384 × 192 (its sigma
   plane the sigma-only kernel's bits); the plane-op backward
   in its four modes (``plane_train`` 16,384 × 64, ``plane_codes``
   4096 × 64, ``plane_pose`` 2048 × 64, ``plane_train_input`` 4096 × 32)
   on the cotangents of a composite's MSE; the standalone composite and its
   backward at 4096 × 96, white and black background, every lane of the
   cotangent nonzero; and the chain identity: planes, composite, MSE,
   composite backward and plane-op backward against the single-pass
   kernel's ``train`` mode (4096 × 64) and ``pose`` mode (2048 × 64) on
   the same inputs; the two flag pairs no path calls, ``train_input``
   (weight and input gradients, 4096 × 32) and ``train_weights`` (the
   weights plane with weight gradients, 16,384 × 32), each against its
   plain version and against the weight-gradient mode on the same inputs
   (its dW/db the same bits). First the CUDA weight packing against its
   plain version (bit-equal); the weight-gradient mode's dW/db must be
   the same bits over two calls; the weight-gradient kernel alone
   (``fused_train.weight_grads``) on the planes of a training-shape call
   (16,384 × 96, every trunk layer) against ``weight_grads_plain``, its
   dW/db the same bits over two calls; the input-chain kernel alone
   (``fused_mlp.input_chain``) at 2048 × 96, 2048 × 64 and 2048 × 32, at
   2047 × 40 (a ragged last chunk) and 300 × 200 (a ray longer than a ring
   stage), and the four-plane head alone (``fused_mlp.plane_head``) on the
   t and r of a planes call at 16,384 × 64, each against its plain version
   and the same bits over two launches, beside its byte bound and one
   PyTorch call for its product (``torch.matmul(gh0, w_enc.T)``,
   ``torch.matmul(r, w_rgb[:, :3])``); the sigma-only head alone
   (``fused_mlp.sigma_head``) on the t of a sigma call at 16,384 × 32 and
   at a ragged 2047 × 39, against its plain version, bit-equal to the
   four-plane head's sigma plane on the same t and over two launches,
   beside its byte bound and ``torch.matmul(t, w_sig)``; the code
   cotangents' last pass alone (``fused_train.fold_ray_sums``) on seeded
   f32 spans as the dx kernel leaves them (``FOLD_SHAPES``; exact ties,
   ±0, subnormals, values near the bf16 maximum), each output bit-equal
   to ``fold_ray_sums_plain``'s, beside its byte bound and
   ``x.to(torch.bfloat16)``; every mode that writes code cotangents
   gives the same bits in ``d_sproj``, ``d_tproj`` and ``d_vcontrib``
   over two launches on one input (``repeat_checks``); the
   small kernels' device ms against their byte bounds
   (``sigma_head_kernel`` in ``sigma_fwd``, ``ray_sum_fold_kernel`` in a
   training call on packed operands, one launch a call, where
   ``pack_kernel`` must not run; ``pack_kernel`` alone); the code tables'
   gradient alone (``code_rows.code_row_sums``: ``code_row_tiles_kernel``
   + ``code_row_fold_kernel``) on seeded cotangents of 16,384 rays × 512
   columns at 4, 16 and 2,458 objects and on a ragged batch whose even
   objects have no rays (``CODE_ROW_CASES``), bit-equal to
   ``code_row_sums_plain`` and over two launches, beside its byte bound,
   ``index_add_`` and ``index_put_(accumulate=True)``. After the
   packing's check, the packed-operand cache across a fused AdamW step
   through ``apply_update``: training and pose calls on the rebuilt
   operands bit-equal to the same calls on a freshly packed buffer, and
   different on the buffer from before the step. The standalone
   composite also runs on seeded planes at ragged shapes
   (``COMPOSITE_RAGGED``). Timings of each kernel, its plain
   version and its bound, a ``torch.profiler`` breakdown by kernel name,
   the trunk kernels' ms per launch and TFLOP/s, the head kernel's ms and
   GB/s and the weight-gradient kernel's ms, TFLOP/s and GB/s against its
   byte floor, beside ``torch.matmul(X.t(), G)`` over the same planes (the
   yardstick; the port never calls it), and ``fixed_sum_kernel``'s ms
   against its byte bound;
3. coarse training: ``codenerf_tpu_torch.train.main`` at
   ``jsonfiles/srncar_fused.json`` widths and the CLI's batch of 16,384
   rays on a seeded SRN-layout ``cars_train`` set (4 objects x 4 views,
   128x128): 10 steps crossing the crop->full switch at step 5, with a
   checkpoint at mid-run (step 5) and at the end; then a second run
   resumes (``--resume``) from a copy of the mid-run checkpoint and runs
   the last 5 steps again. Each run's launch count of the weight-gradient
   kernel and of the weight packing must equal its steps, and of the code
   tables' gradient (``code_rows``) twice its steps, one a table; every
   logged loss must be finite, and the
   resumed run must end at the uninterrupted run's loss. Then the step
   profile (wall ms untraced and under the profiler, device-busy ms split
   into the port's kernels and PyTorch's, idle share, the largest kernels
   by name);
4. coarse test-time optimization: ``codenerf_tpu_torch.optimize.main``
   reads the training run's ``ckpt/`` and fits codes for a seeded
   ``cars_test`` set (2 objects x 4 views); the frozen-model kernel's
   launch count must equal steps x chunks x objects, the eval's views one
   ``planes`` and one ``composite`` launch a group of whole chunks up to
   ``renderer.KERNEL_RAYS`` rays (the forward kernels' route of
   ``renderer.render_image``; a 128×128 view in one), and
   ``results.json`` must be finite; then that step's profile;
5. hierarchical training at ``jsonfiles/srncar_hier_occ.json`` widths
   (32 coarse + 32 fine samples, sphere bounds, the training occupancy
   grid with its warm-up cut to 4 steps and its refresh to every 2):
   8 steps, then a run resumed from the step-4 checkpoint, which must
   rebuild the grid. Each step launches the sigma-only forward once, the
   dual training kernel once and ``code_rows`` twice; then the step
   profile;
6. hierarchical test-time optimization with ``--opt_occ true`` on that
   run: the sigma-only and the dual frozen kernel each once per chunk,
   step and object, and the eval's views through the forward kernels'
   hierarchical route (one ``sigma``, ``planes`` and ``composite`` a
   launch group); then the step profile;
7. coarse pose optimization: ``codenerf_tpu_torch.pose_opt.main`` on the
   coarse run (2 objects of ``cars_test``, 20 steps of 2048 rays, the
   protocol runs 400): one ``pose`` launch per step, and one ``planes``
   and ``composite`` per launch group of each object's two strip renders
   (the forward kernels' route); finite ``results.json``; then the pose
   step's profile;
8. hierarchical pose optimization on the hierarchical run: one
   ``pose_weights`` and one ``pose`` launch per step, and one ``sigma``,
   ``planes`` and ``composite`` per launch group of each strip render;
9. the separate fine network (``srncar_hier_occ.json`` with
   ``hierarchical_share_weights: false``, phase 5's cuts): 8 training
   steps and 4 resumed from step 4, which must rebuild the grid and
   repeat the uninterrupted run's losses; each step one ``planes`` and
   one ``plane_train`` launch per network, and two ``code_rows``;
10. ``optimize --opt_occ true`` on that run: one ``planes`` and one
    ``plane_codes`` launch per network, chunk, step and object, and one
    ``sigma`` (coarse network), ``planes`` (fine) and ``composite`` per
    launch group of each eval view;
11. the pose CLI on that run: one ``planes`` and one ``plane_pose``
    launch per network and step, and the strips as phase 10's eval;
12. padded chunks: ``optimize`` on the coarse run of phase 3 against a
    seeded ``cars_test`` set at 127×127 (16,129 rays, 4 chunks of 4096):
    one ``planes``, ``composite``, ``composite_bwd`` and ``plane_codes``
    launch per chunk, step and object, and one ``planes`` and
    ``composite`` per launch group of each eval view; the first step's
    PSNR recomputed from the same draws with the plain versions on the
    unpadded rays.
    Phases 3-12 each start with every launch count at 0, fail if a plain
    version ran on a CUDA tensor, and print the peak device memory and
    their step profiles (which fail on any ``index_add_``, by op or
    kernel name); the weights are packed once per network and
    training step, and once per network in a fitting or pose run (none
    in a frozen step's profiled window);
13. every CUDA kernel's launches on the main paths by name, the order of
    the next work (each mode's ms above its bound, summed over the main
    paths' launches, each launch priced at its own R·S points against the
    phase-2 shape's; the conversion's launches at their rays against the
    phase-2 span's), the ``kernels`` JSON line (22 rows: the 16 modes,
    then ``input_chain_kernel``, ``plane_head_kernel``,
    ``sigma_head_kernel`` and ``ray_sum_fold_kernel``, whose launches are
    those of the modes that run them, ``pack_kernel``, counted by its own
    wrapper, and ``code_rows``, the code tables' gradient), the card
    line, and the last line ``{"ok": true, "device": {...}}`` (after
    phases 14 and 16-18);
14. quality, cut, printed after the ``kernels`` line: the port's quality
    report (``codenerf_tpu_torch.quality_report``, the twin of
    ``tools/quality_report.py``) on seed 0 of the standard protocol at
    the flagship widths, fused single pass, 96 samples, 16 + 4 synthetic
    objects, 24 views at 64×64, cut to 1,000 training steps of 8192
    rays; then the 4 held-out objects fitted again on the trained
    checkpoint sequentially, with ``--opt_group 4``, with
    ``--opt_rays 1024``, and with ``--opt_group 4`` on scenes rendered on
    the card (``--scene_backend device``), its eval scored on the scene's
    pixels and then on ground truth rendered on the card
    (``--device_gt``). It prints the training PSNR at each logged step,
    each object's fitting start -> end PSNR and held-out PSNR/SSIM, and
    each run's fitting and eval seconds an object, and fails on a
    non-finite value, a training PSNR that does not rise, an object whose
    fitting does not end above its start, two sequential fits whose codes
    are not the same bits, an ``--opt_group`` row off the sequential
    rerun's (fitting start by 1e-4 dB, held-out PSNR by 0.01 dB, SSIM by
    1e-3; ``quality_path`` says why), or a ``--device_gt`` row off the
    device-scene arm's (other codes, or held-out PSNR by 0.02 dB or SSIM
    by 1e-3; ``device_gt_check``). Each run counts its launches in
    its own window (one ``train`` and one ``pack`` a training step, one
    ``codes`` a fitting step and object, one ``pack`` a fitting run, one
    ``planes`` and one ``composite`` an eval view); they are not in the
    ``kernels`` line, which phases 3-12 count;
15. the user-facing tools, run after phase 12 (before the ``kernels``
    line) on phase 3's coarse run and phase 5's occupancy run, all at
    flagship widths (``service_path``): the render service
    (``codenerf_tpu_torch.serving.RenderServer`` on 127.0.0.1:0 in a
    background thread) answers 128×128 renders by object, by raw codes
    with an orbit camera and, on the hierarchical run, with a
    per-object occupancy grid, each PNG equal to ``render_image`` of the
    same camera, codes and grid, uint8 for uint8; the three error paths;
    20 more renders and ``/stats``' p50 and p95 beside the card line.
    The export of the coarse run read back bit-equal and the separate-fine
    run refused; ``edit --objects 0 1 --grid 3`` (the swap matrix's
    diagonal equal to direct renders), ``render_orbit`` with 4 frames and
    ``estimate_bound_radius``. Every render takes the forward kernels
    (``renderer.kernel_route``: one ``planes`` and one ``composite`` a
    view, and on the hierarchical run one ``sigma`` before them; one
    ``pack`` for each tool's model). A served view of the coarse run,
    and 64 + 128 views of networks drawn as the served cells draw them
    (the density sharpened), separate and shared, are held against the
    plain module(s) at float32 on the same rays, no further from it than
    the bf16 plain module is (the hierarchical run's view and phase 9's
    separate fine network at 64 + 128 are printed); the radius estimate
    goes through the plain module, as the JAX package renders through
    XLA. No other port kernel launches in it.
16. after phase 14, before the card line: the device scene renderers
    at full scale and the native ray sampler (``scene_path``). The test
    split of the full-scale chair protocol (704 objects × 250 views at
    128×128, 8,650,752,000 B of uint8 on the host, after ``free -g``) is
    rendered with ``synthetic_scene(backend="device")``: its wall, the
    render alone, the copy rates and the peak device memory; 64 seeded
    pairs must be within one level of the numpy path's bytes with under
    0.5% of pixels differing, ``params_only`` must draw the same poses
    and parameters, and ``make_gt_view_renderer`` must give 8 of the
    pairs' bytes to 1/255. Then ``native/ray_sampler.cpp`` is built on the
    card's host (``data/native.py``), ``RayBatchPipeline(backend="auto")``
    must take it, and 200 batches of 16,384 rays through each backend and
    layout on that split are timed (rays/s); every native batch must
    gather ``images[obj, view, v, u]`` and a crop batch stay in the crop.
    No port kernel launches in it: the renderers are plain PyTorch, as
    the JAX package's are XLA.

17. the process mesh (``mesh_path``): (a) a ``srncar_fused.json`` step
    at world size 1 over NCCL with ``make_mesh(data=1)``, the same bits
    as one process's (loss and every gradient), timed and profiled in
    turns with and without the mesh, and ``torchrun ... train
    --data_axis 1``; (b) two gloo ranks sharing the card, each step
    against one process at ``_close``'s bars (the shards' sums differ
    in order by nature) and a sharded fit the same bits; (c) the
    ``model`` axis, ``(data=1, model=2)`` on two gloo ranks at
    ``srncar.json`` widths: each step the same bits as one process's
    from the same weights, batch and depths, and one hierarchical step
    shared and with a separate fine network the same;
18. training repeats (``repeat_path``): for each route — (a)
    ``srncar_fused.json``, (b) ``srncar_hier_occ.json`` with phase 5's
    cuts, (c) the separate fine network of phase 9, (d) ``srncar.json``
    (autodiff), (e) (a) under ``make_mesh(data=1)`` over NCCL — two fresh
    trainers of one seed run 12 steps of 16,384 rays across the
    crop→full switch on phase 3's seeded set; every parameter, both code
    tables, every AdamW moment and step count, the generator and every
    logged loss must be the same bits, and each run launch each kernel
    as its steps say. ``repeat_path(diagnose=True)`` then runs (a)-(d) 2
    steps each under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` and prints what it warns about (not in the
    default run).

Any failure exits non-zero without the last line. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
R_CODES, R_TRAIN, S_FULL = 4096, 16384, 96
S_COARSE, S_UNION = 32, 64   # srncar_hier_occ.json: 32 coarse + 32 fine
# NeRF's published counts (portbench's car_nerf_hier cell): 64 coarse, and
# the fine network at the union with 128 fine
S_NERF_COARSE, S_NERF_UNION = 64, 192
R_POSE = 2048                # tools/pose_opt.py --rays_per_step
INPUT_CHAIN = ("d_ro8", "d_vd8", "d_z")   # the pose modes' input chain
SOURCE = "codenerf_tpu_torch/ops/csrc/train_fused.cu"
REPLACES = "codenerf_tpu/ops/fused_train.py:447"
REPLACES_SIGMA = "codenerf_tpu/ops/fused_mlp.py:518"
REPLACES_PLANES = "codenerf_tpu/ops/fused_mlp.py:518"
REPLACES_BWD = "codenerf_tpu/ops/fused_train.py:846"
REPLACES_COMPOSITE = "codenerf_tpu/ops/pallas_composite.py:84"
REPLACES_INPUT = "codenerf_tpu/ops/fused_train.py:615"
REPLACES_HEADS = "codenerf_tpu/ops/fused_mlp.py:363"
REPLACES_SIGMA_HEAD = "codenerf_tpu/ops/fused_mlp.py:362"
REPLACES_FOLD = "codenerf_tpu/ops/fused_train.py:321"
SOURCE_CODE_ROWS = "codenerf_tpu_torch/ops/csrc/code_rows.cu"
# XLA's scatter-add, the transpose of the training step's code gather.
REPLACES_CODE_ROWS = "codenerf_tpu/training/train_step.py:329"
D_CODES = 512       # both code tables' columns (latent 256 each)
# The points (R * S) of each mode's phase-2 check: its ms and bound_ms
# are taken there.
PHASE2_POINTS = {
    "codes": R_CODES * S_FULL, "train": R_TRAIN * S_FULL,
    "sigma": R_TRAIN * S_COARSE, "dual_train": R_TRAIN * S_UNION,
    "dual_codes": R_CODES * S_UNION, "pose": R_POSE * S_FULL,
    "pose_weights": R_POSE * S_COARSE, "planes": R_TRAIN * S_UNION,
    "plane_train": R_TRAIN * S_UNION, "plane_codes": R_CODES * S_UNION,
    "plane_pose": R_POSE * S_UNION, "plane_train_input": R_CODES * S_COARSE,
    "composite": R_CODES * S_FULL, "composite_bwd": R_CODES * S_FULL,
    "train_input": R_CODES * S_COARSE, "train_weights": R_TRAIN * S_COARSE,
    "input_chain": R_POSE * S_FULL, "plane_head": R_TRAIN * S_UNION,
    "sigma_head": R_TRAIN * S_COARSE,
    "ray_sum_fold": R_TRAIN,   # the conversion's work goes by rays
    "pack": 1,                # the packing's by launches
    "code_rows": R_TRAIN * D_CODES}   # the table gradient's by R·D
PLANE_MODES = {   # launch counter: (weight_grads, input_grads)
    "plane_train": (True, False), "plane_codes": (False, False),
    "plane_pose": (False, True), "plane_train_input": (True, True)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _close(name, got, want, terms=None, per_ray=False, slack=1.0,
           quiet=False):
    """Kernel vs plain version. Both round to bf16 at the same points, so
    they differ by f32 summation order, which flips an occasional bf16
    rounding. The bar: relative L2 error below 5e-3 (the bar of
    tests/test_torch_fused_train.py, where JAX and the plain version
    measure 1.3e-3 to 2.4e-3); fewer than 1e-3 of the elements outside
    the test's elementwise bar of 1e-2 of the largest magnitude plus 5e-3
    relative — at millions of elements per cotangent a few per-ray sums
    that nearly cancel keep the absolute error of their terms; and a
    guard against gross errors: every element within 5e-2 of the output's
    largest magnitude or, for the per-ray outputs (``per_ray``, rows =
    rays), every ray's row within a relative L2 error of 0.25. A wrong
    ray is off by its own size (relative error ~1). The element guard
    does not carry over to per-ray sums at 16,384 rays: its largest
    deviation grows with the element count (12.6M per cotangent, against
    3.1M at the 4096-ray chunk, where it reads 2.5-4.3% of the largest
    magnitude), and the weight-gradient mode's cotangents equal the
    frozen mode's on the same inputs (``kernel_check``).
    ``terms``: for the sigma head's sums Σ t·dsig and Σ dsig, whose terms
    cancel heavily (tests/test_torch_train_step.py), the largest sum of
    the terms' magnitudes takes the place of the largest magnitude and
    the relative L2 test is dropped. ``slack`` multiplies the relative L2
    bar and the guard: 2 for the pose modes' ``d_ro8``, ``d_vd8`` and
    ``d_z`` (``INPUT_CHAIN``), the code cotangents' chain continued
    through enc_xyz and the PE Jacobian, whose lanes carry factors up to
    2^9 and whose sums over lanes and samples cancel, so that each flipped
    bf16 rounding of the chain weighs up to about twice as much: on the
    card they measure 1.4-2.1 times the relative L2 error of d_sproj, the
    same chain's sum one layer earlier, on the same call (PERF.md, PR 4).
    ``quiet`` logs a failure only. Returns (max abs error, passed)."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = float(want.abs().max()) if terms is None else float(terms.max())
    rel_l2 = float(torch.linalg.vector_norm(got - want)
                   / torch.linalg.vector_norm(want).clamp_min(1e-30))
    outside = float((err > 1e-2 * top + 5e-3 * want.abs()).float().mean())
    elem = float(err.max()) / max(top, 1e-30)
    guard = f"largest error at {elem:.2e} of the scale"
    if per_ray:
        g2, w2 = got.reshape(got.shape[0], -1), want.reshape(got.shape[0], -1)
        norms = torch.linalg.vector_norm(w2, dim=1)
        # An all-zero reference (the sigma cotangent at S = 1) scores its
        # rows' absolute error: 0/0 reads 0, any nonzero row fails.
        floor = max(1e-2 * float(norms.max()), 1e-30)
        ray_err = float((torch.linalg.vector_norm(g2 - w2, dim=1)
                         / norms.clamp_min(floor)).max())
        guard += f", worst ray's relative L2 {ray_err:.2e}"
        guard_ok = ray_err < 0.25 * slack
    else:
        guard_ok = elem <= 5e-2 * slack
    ok = (bool(torch.isfinite(got).all())
          and (terms is not None or rel_l2 < 5e-3 * slack)
          and guard_ok and outside < 1e-3)
    if ok and quiet:
        return float(err.max()), ok
    log(f"  {name}: max_abs_err {float(err.max()):.3e} (scale {top:.3e}) "
        f"rel_l2 {rel_l2:.3e}, share outside the elementwise bar "
        f"{outside:.2e}; {guard}{'' if ok else '  <-- FAILS'}")
    return float(err.max()), ok


def time_cuda(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(dev, R: int, S: int):
    """Seeded full-width operands of one kernel call, the weights last as
    the ``TrunkOperands`` the main paths' calls read, packed here once
    (``fused_train.fresh_trunk_operands``: one pack_kernel launch) so
    that the timed calls run what the main paths run."""
    import torch

    from codenerf_tpu_torch.config import NetConfig
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.ops import fused_mlp, fused_train

    cfg = NetConfig()                      # srncar_fused.json widths
    gen = torch.Generator(device=dev).manual_seed(1)
    model = CodeNeRF(cfg, generator=gen, device=dev).requires_grad_(False)
    ro = torch.rand(R, 3, generator=gen, device=dev) * 0.6 - 0.3
    ro = ro + torch.tensor([0.0, 0.0, 1.3], device=dev)
    vd = torch.randn(R, 3, generator=gen, device=dev)
    vd = vd / vd.norm(dim=-1, keepdim=True)
    z = 0.8 + torch.sort(torch.rand(R, S, generator=gen, device=dev),
                         -1).values
    sc = torch.randn(cfg.latent_dim, generator=gen, device=dev) * 0.1
    tc = torch.randn(cfg.latent_dim, generator=gen, device=dev) * 0.1
    gt = torch.rand(R, 3, generator=gen, device=dev)
    ro8, vd8, z, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
        model, cfg, ro, vd, z, sc, tc)
    trunk = fused_train.fresh_trunk_operands(
        cfg, fused_train.flatten_params(model, cfg))
    return cfg, (cfg, S, R, True, 1.0 / (R * 3.0), ro8, vd8, z, sproj, tproj,
                 vcontrib, fused_mlp.pad_lanes(gt, 8), trunk)


def _bound(flops: int, nbytes: int):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def bound(cfg, R: int, S: int, wops, weight_grads: bool, dual: bool = False,
          input_grads: bool = False, want_weights: bool = False):
    """(bound ms, bound_by, FLOP, bytes): matmul operations at the dense
    bf16 peak against the bytes the function must move (inputs read once,
    outputs written once) at the HBM rate. The dual mode reads the coarse
    mask and deltas besides; ``input_grads`` adds the input chain's 2·64·W
    FLOP per point and writes d_ro8, d_vd8, d_z, ``want_weights`` the
    weights plane; the frozen mode writes the rgb rows."""
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    P = R * S
    fwd = 2 * P * (64 * W + W * W * (nb + nt + 2) + W * W // 2)
    dx = 2 * P * (W * W * (nb + nt + 2) + W * W // 2)
    flops = fwd + dx + (fwd if weight_grads else 0)
    w_bytes = sum(w.numel() * w.element_size() for w in wops)
    in_bytes = R * 8 * 4 * 3 + R * S * 4 + R * (nb + nt + 1) * W * 2 + w_bytes
    if dual:
        in_bytes += 2 * R * S * 4
    out_bytes = R * 8 * 4 + R * (nb + nt + 1) * W * 2
    if weight_grads:
        out_bytes += 4 * sum(w.numel() for w in wops)
    if input_grads:
        flops += 2 * P * 64 * W
        out_bytes += R * 8 * 4 * 2 + R * S * 4
    if want_weights:
        out_bytes += R * S * 4
    if not weight_grads and not input_grads:
        out_bytes += R * 8 * 4                     # rgb8
    return _bound(flops, in_bytes + out_bytes)


def sigma_bound(cfg, R: int, S: int, wops):
    """The sigma-only forward's bound: 2W(64 + W(nb+1)) FLOP per point;
    it reads the rays, depths, shape latents and the trunk's weights and
    writes sigma."""
    W, nb = cfg.W, cfg.shape_blocks
    flops = 2 * R * S * W * (64 + W * (nb + 1))
    w_bytes = sum(w.numel() * w.element_size() for w in wops[:2 * (nb + 3)])
    nbytes = R * 8 * 4 * 2 + R * S * 4 + R * nb * W * 2 + w_bytes + R * S * 4
    return _bound(flops, nbytes)


def kernel_check(dev, weight_grads: bool):
    """Phase 2: train_fused (CUDA) vs train_fused_plain at full width, in
    the frozen-model mode (R=4096) or the weight-gradient mode
    (R=16,384)."""
    import torch

    from codenerf_tpu_torch.ops import fused_train

    R, S = (R_TRAIN if weight_grads else R_CODES), S_FULL
    cfg, args = kernel_inputs(dev, R, S)
    kw = (dict(weight_grads=True) if weight_grads
          else dict(want_rgb=True, weight_grads=False))
    got = fused_train.train_fused(*args, **kw)
    torch.cuda.synchronize()
    terms = []
    want = fused_train.train_fused_plain(*args, sigma_terms=terms, **kw)
    torch.cuda.synchronize()
    ray_outs = ["d_sproj", "d_tproj", "d_vcontrib", "rgb8"]
    names = ray_outs[:3]
    names += ([f"{n}.{k}" for n, _, _ in fused_train.weight_shapes(cfg)
               for k in ("w", "b")] if weight_grads else ["rgb8"])
    scale = dict(zip(["sigma.w", "sigma.b"], terms))
    checks = [("se_sum", *_close("se_sum", got[0].reshape(1),
                                 want[0].reshape(1)))]
    for name, g, w in zip(names, got[1:], want[1:]):
        checks.append((name, *_close(name, g, w, scale.get(name),
                                     per_ray=name in ray_outs)))
    again = fused_train.train_fused(*args, **kw)
    checks += repeat_checks(names, got[1:], again[1:])
    if weight_grads:
        # The per-ray cotangents come from the same dx chain in both
        # modes: on the same inputs the frozen mode must give them to
        # within 1e-2 of the largest magnitude.
        frozen = fused_train.train_fused(*args, weight_grads=False)
        for name, a, b in zip(["se_sum", "d_sproj", "d_tproj",
                               "d_vcontrib"], got[:4], frozen):
            d = float((a.float() - b.float()).abs().max())
            ok = d <= 1e-2 * float(b.float().abs().max())
            log(f"  {name}: weight-gradient vs frozen mode, max abs "
                f"difference {d:.3e}{'' if ok else '  <-- FAILS'}")
            checks.append((f"{name} (vs frozen mode)", d, ok))
        del frozen
        # dW and db come from gh planes written without atomics and
        # fixed-order sums: the same bits on every call.
        ok = all(torch.equal(a, b) for a, b in zip(got[4:], again[4:]))
        log(f"  dW/db over two calls: {'bit-equal' if ok else 'DIFFER'}"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append(("dW/db (two calls)", 0.0, ok))
    del got, want, again
    failed = [name for name, _, ok in checks if not ok]
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version on "
                             f"{failed}")
    errs = [e for name, e, _ in checks if "(" not in name]

    ms = time_cuda(lambda: fused_train.train_fused(*args, **kw), reps=10)
    plain_ms = time_cuda(lambda: fused_train.train_fused_plain(*args, **kw),
                         reps=3)
    bound_ms, bound_by, flops, nbytes = bound(cfg, R, S, args[-1].wops,
                                              weight_grads)
    log(f"  kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound "
        f"{bound_ms:.4f} ms ({flops:.4e} FLOP at {PEAK_BF16_FLOPS:.3e}/s; "
        f"{nbytes} B at {PEAK_HBM_BYTES:.3e} B/s) at R={R}, S={S}")
    profile_breakdown(lambda: fused_train.train_fused(*args, **kw),
                      sequence=weight_grads)
    trunk_rates(cfg, R, S, lambda: fused_train.train_fused(*args, **kw),
                weight_grads)
    head_dw_rates(cfg, R, S, lambda: fused_train.train_fused(*args, **kw),
                  weight_grads)
    mode = ("weight_grads=True" if weight_grads
            else "weight_grads=False, want_rgb")
    return {"name": f"train_fused ({mode})", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def sigma_check(dev, R: int, S: int = S_COARSE):
    """Phase 2: sigma_fwd (CUDA) vs sigma_fwd_plain at R rays x S coarse
    samples."""
    import torch

    from codenerf_tpu_torch.ops import fused_mlp

    cfg, args = kernel_inputs(dev, R, S)
    _, S, R, _, _, ro8, vd8, z, sproj, tproj, vcontrib, _, trunk = args
    sargs = (cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib, trunk)
    got = fused_mlp.sigma_fwd(*sargs)
    torch.cuda.synchronize()
    want = fused_mlp.sigma_fwd_plain(*sargs)
    err, ok = _close(f"sigma (R={R})", got, want, per_ray=True)
    if not ok:
        raise AssertionError(f"sigma_fwd disagrees with its plain version "
                             f"at R={R}")
    ms = time_cuda(lambda: fused_mlp.sigma_fwd(*sargs), reps=10)
    plain_ms = time_cuda(lambda: fused_mlp.sigma_fwd_plain(*sargs), reps=3)
    bound_ms, bound_by, flops, nbytes = sigma_bound(cfg, R, S, trunk.wops)
    log(f"  kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound "
        f"{bound_ms:.4f} ms ({flops:.4e} FLOP; {nbytes} B) at R={R}, S={S}")
    profile_breakdown(lambda: fused_mlp.sigma_fwd(*sargs), sequence=True)
    return {"name": "sigma_fwd (sigma_only)", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES_SIGMA, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def union_inputs(dev, R: int):
    """Full-width operands at a real union: seeded coarse depths, their
    coarse weights from the plain sigma-only forward, then
    hier_fine_zvals_meta's fine draw, union and dual planes."""
    import torch

    from codenerf_tpu_torch.core.render import composite_weights
    from codenerf_tpu_torch.ops import fused_mlp, fused_train

    cfg, args = kernel_inputs(dev, R, S_COARSE)
    _, S, R, wbg, scale, ro8, vd8, zc, sproj, tproj, vcontrib, gt8, trunk = \
        args
    sig = fused_mlp.sigma_fwd_plain(cfg, S, R, ro8, vd8, zc, sproj, tproj,
                                    vcontrib, trunk)
    gen = torch.Generator(device=dev).manual_seed(2)
    z_all, cmask, cdelta = fused_train.hier_fine_zvals_meta(
        zc, composite_weights(sig, zc), gen, S_UNION - S_COARSE)
    return cfg, (cfg, S_UNION, R, wbg, scale, ro8, vd8, z_all, sproj, tproj,
                 vcontrib, gt8, trunk), dict(coarse_mask=cmask,
                                             coarse_delta=cdelta)


def dual_check(dev, weight_grads: bool):
    """Phase 2: the dual-composite mode (CUDA) vs train_fused_plain at a
    real union of 32 coarse and 32 fine depths: training at R=16,384 (and
    its cross-checks), frozen with want_rgb at R=4096."""
    import torch

    from codenerf_tpu_torch.ops import fused_train

    R = R_TRAIN if weight_grads else R_CODES
    cfg, args, planes = union_inputs(dev, R)
    kw = (dict(weight_grads=True) if weight_grads
          else dict(want_rgb=True, weight_grads=False))
    kw.update(planes)
    got = fused_train.train_fused(*args, **kw)
    torch.cuda.synchronize()
    terms = []
    want = fused_train.train_fused_plain(*args, sigma_terms=terms, **kw)
    torch.cuda.synchronize()
    ray_outs = ["d_sproj", "d_tproj", "d_vcontrib", "rgb8"]
    names = ["se_fine", "se_coarse"] + ray_outs[:3]
    names += ([f"{n}.{k}" for n, _, _ in fused_train.weight_shapes(cfg)
               for k in ("w", "b")] if weight_grads else ["rgb8"])
    scale = dict(zip(["sigma.w", "sigma.b"], terms))
    checks = []
    for name, g, w in zip(names, got, want):
        if name.startswith("se_"):
            g, w = g.reshape(1), w.reshape(1)
        checks.append((name, *_close(name, g, w, scale.get(name),
                                     per_ray=name in ray_outs)))
    again = fused_train.train_fused(*args, **kw)
    checks += repeat_checks(names, got, again)
    del again
    if weight_grads:
        # The dual frozen mode on the same inputs gives the per-ray
        # cotangents to within 1e-2 of the largest magnitude; the non-dual
        # frozen kernel on the same union gives the fine SE to within the
        # f32 summation order of the per-ray rows.
        frozen = fused_train.train_fused(*args, weight_grads=False, **planes)
        for name, a, b in zip(["se_fine", "se_coarse", "d_sproj", "d_tproj",
                               "d_vcontrib"], got[:5], frozen):
            d = float((a.float() - b.float()).abs().max())
            ok = d <= 1e-2 * float(b.float().abs().max())
            log(f"  {name}: dual weight-gradient vs dual frozen mode, max "
                f"abs difference {d:.3e}{'' if ok else '  <-- FAILS'}")
            checks.append((f"{name} (vs dual frozen mode)", d, ok))
        single = fused_train.train_fused(*args, weight_grads=False)
        d = abs(float(got[0]) - float(single[0]))
        ok = d <= 1e-5 * abs(float(single[0]))
        log(f"  se_fine {float(got[0]):.6e} vs the non-dual frozen kernel's "
            f"SE {float(single[0]):.6e} on the same union: difference "
            f"{d:.3e}{'' if ok else '  <-- FAILS'}")
        checks.append(("se_fine (vs non-dual)", d, ok))
        del frozen, single
    del got, want
    failed = [name for name, _, ok in checks if not ok]
    if failed:
        raise AssertionError(f"dual mode disagrees with its plain version "
                             f"on {failed}")
    errs = [e for name, e, _ in checks if "(vs" not in name]
    ms = time_cuda(lambda: fused_train.train_fused(*args, **kw), reps=10)
    plain_ms = time_cuda(lambda: fused_train.train_fused_plain(*args, **kw),
                         reps=3)
    bound_ms, bound_by, flops, nbytes = bound(cfg, R, S_UNION, args[-1].wops,
                                              weight_grads, dual=True)
    log(f"  kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound "
        f"{bound_ms:.4f} ms ({flops:.4e} FLOP; {nbytes} B) at R={R}, "
        f"S={S_UNION}")
    profile_breakdown(lambda: fused_train.train_fused(*args, **kw))
    mode = ("dual, weight_grads=True" if weight_grads
            else "dual, weight_grads=False, want_rgb")
    return {"name": f"train_fused ({mode})", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def pose_check(dev, S: int, want_weights: bool, union: bool = False):
    """Phase 2: a pose mode (CUDA) vs train_fused_plain at R=2048 rays:
    every output, the SE and code cotangents against the frozen mode on
    the same inputs, and d_ro8, d_vd8, d_z over two launches. ``union``
    takes a real union of 32 coarse and 32 fine depths."""
    import torch

    from codenerf_tpu_torch.ops import fused_train

    if union:
        cfg, args, _ = union_inputs(dev, R_POSE)
    else:
        cfg, args = kernel_inputs(dev, R_POSE, S)
    S = args[1]
    kw = dict(weight_grads=False, input_grads=True, want_weights=want_weights)
    got = fused_train.train_fused(*args, **kw)
    torch.cuda.synchronize()
    want = fused_train.train_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    names = (["se_sum", "d_sproj", "d_tproj", "d_vcontrib"]
             + ["weights"] * want_weights + list(INPUT_CHAIN))
    checks = []
    for name, g, w in zip(names, got, want):
        if name == "se_sum":
            g, w = g.reshape(1), w.reshape(1)
        checks.append((name, *_close(
            name, g, w, per_ray=name != "se_sum",
            slack=2.0 if name in INPUT_CHAIN else 1.0)))
    # The pose modes only append to the frozen mode's chain: the SE and
    # the code cotangents within 1e-2 of the largest magnitude, as
    # kernel_check; over two launches the code cotangents and the input
    # chain's outputs (a deterministic GEMM output, fixed-order sums) are
    # the same bits.
    frozen = fused_train.train_fused(*args, weight_grads=False)
    for name, a, b in zip(names[:4], got[:4], frozen):
        d = float((a.float() - b.float()).abs().max())
        ok = d <= 1e-2 * float(b.float().abs().max())
        log(f"  {name}: pose vs frozen mode, max abs difference "
            f"{d:.3e}{'' if ok else '  <-- FAILS'}")
        checks.append((f"{name} (vs frozen mode)", d, ok))
    again = fused_train.train_fused(*args, **kw)
    checks += repeat_checks(names, got, again)
    for name, a, b in zip(names[-3:], got[-3:], again[-3:]):
        ok = torch.equal(a, b)
        log(f"  {name}: two launches {'bit-equal' if ok else 'DIFFER'}"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append((f"{name} (two launches)", 0.0, ok))
    del got, want, frozen, again
    failed = [name for name, _, ok in checks if not ok]
    if failed:
        raise AssertionError(f"pose mode disagrees on {failed}")
    errs = [e for name, e, _ in checks if "(" not in name]
    ms = time_cuda(lambda: fused_train.train_fused(*args, **kw), reps=10)
    plain_ms = time_cuda(lambda: fused_train.train_fused_plain(*args, **kw),
                         reps=3)
    bound_ms, bound_by, flops, nbytes = bound(
        cfg, R_POSE, S, args[-1].wops, False, input_grads=True,
        want_weights=want_weights)
    log(f"  kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound "
        f"{bound_ms:.4f} ms ({flops:.4e} FLOP; {nbytes} B) at R={R_POSE}, "
        f"S={S}")
    profile_breakdown(lambda: fused_train.train_fused(*args, **kw),
                      sequence=True)
    mode = ("weight_grads=False, input_grads, want_weights" if want_weights
            else "weight_grads=False, input_grads")
    return {"name": f"train_fused ({mode})", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def plane_bound(cfg, R: int, S: int, wops, weight_grads: bool = False,
                input_grads: bool = False, forward_only: bool = False):
    """The plane op's bounds. The four-plane forward (``forward_only``):
    2W(64 + W(nb+nt+2) + W/2) FLOP per point; it reads the rays, depths,
    per-ray operands and weights and writes four (R, S) f32 planes. The
    backward recomputes that forward and runs the dx chain, plus the dW
    products with ``weight_grads`` and the input chain (2·64·W per point)
    with ``input_grads``; it also reads the four cotangent planes and
    writes the code cotangents, [the dW/db], [d_ro8, d_vd8, d_z]."""
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    P = R * S
    fwd = 2 * P * (64 * W + W * W * (nb + nt + 2) + W * W // 2)
    w_bytes = sum(w.numel() * w.element_size() for w in wops)
    in_bytes = R * 8 * 4 * 2 + P * 4 + R * (nb + nt + 1) * W * 2 + w_bytes
    if forward_only:
        return _bound(fwd, in_bytes + 4 * P * 4)
    flops = 2 * fwd - 2 * P * 64 * W + (fwd if weight_grads else 0)
    out_bytes = R * (nb + nt + 1) * W * 2
    if weight_grads:
        out_bytes += 4 * sum(w.numel() for w in wops)
    if input_grads:
        flops += 2 * P * 64 * W
        out_bytes += R * 8 * 4 * 2 + P * 4
    return _bound(flops, in_bytes + 4 * P * 4 + out_bytes)


def _entry(name, replaces, err, ms, plain_ms, bnd):
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None}


def _timings(fn, plain, bnd, what: str, plain_reps: int = 3):
    """(kernel ms, plain ms) by CUDA events, logged beside the bound."""
    ms = time_cuda(fn, reps=10)
    plain_ms = time_cuda(plain, reps=plain_reps)
    log(f"  kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound "
        f"{bnd[0]:.4f} ms ({bnd[2]:.4e} FLOP; {bnd[3]} B) at {what}")
    return ms, plain_ms


def _fail_on(checks, what: str):
    failed = [name for name, _, ok in checks if not ok]
    if failed:
        raise AssertionError(f"{what} disagrees on {failed}")
    return max(e for name, e, _ in checks
               if "(vs" not in name and "(two" not in name)


CODE_COTANGENTS = ("d_sproj", "d_tproj", "d_vcontrib")


def repeat_checks(names, got, again) -> list:
    """The code cotangents of two launches on the same inputs: the same
    bits, as ray_sums and ray_sum_fold_kernel add in a fixed order."""
    import torch

    checks = []
    for name, a, b in zip(names, got, again):
        if name in CODE_COTANGENTS:
            ok = torch.equal(a.view(torch.int16), b.view(torch.int16))
            log(f"  {name}: two launches {'bit-equal' if ok else 'DIFFER'}"
                f"{'' if ok else '  <-- FAILS'}")
            checks.append((f"{name} (two launches)", 0.0, ok))
    return checks


def planes_check(dev, R: int, S: int):
    """Phase 2: planes_fwd (CUDA) vs planes_fwd_plain, each plane; its
    sigma plane against the sigma-only kernel's on the same inputs (the
    same trunk, GEMMs and head: the same bits)."""
    import torch

    from codenerf_tpu_torch.ops import fused_mlp

    cfg, args = kernel_inputs(dev, R, S)
    _, S, R, _, _, ro8, vd8, z, sproj, tproj, vcontrib, _, trunk = args
    pargs = (cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib, trunk)
    got = fused_mlp.planes_fwd(*pargs)
    torch.cuda.synchronize()
    want = fused_mlp.planes_fwd_plain(*pargs)
    checks = [(n, *_close(n, g, w, per_ray=True))
              for n, g, w in zip(("sigma", "r", "g", "b"), got, want)]
    sig = fused_mlp.sigma_fwd(*pargs)
    ok = torch.equal(sig, got[0])
    log(f"  sigma plane vs sigma_fwd on the same inputs: "
        f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
    checks.append(("sigma (vs sigma_fwd)", 0.0, ok))
    del got, want, sig
    err = _fail_on(checks, "planes_fwd")
    bnd = plane_bound(cfg, R, S, trunk.wops, forward_only=True)
    ms, plain_ms = _timings(lambda: fused_mlp.planes_fwd(*pargs),
                            lambda: fused_mlp.planes_fwd_plain(*pargs), bnd,
                            f"R={R}, S={S}")
    profile_breakdown(lambda: fused_mlp.planes_fwd(*pargs), sequence=True)
    return _entry("planes_fwd (four planes)", REPLACES_PLANES, err, ms,
                  plain_ms, bnd)


def _cotangent_planes(args):
    """The outside cotangents of the four planes as the routes make them:
    the MSE of the composited planes against the seeded targets, with a
    depth term, through the composite's backward (plain versions). Seeded
    random planes instead make every ray's code sums cancel, and the
    per-ray guard then reads the cancellation (PERF.md, Findings)."""
    import torch

    from codenerf_tpu_torch.ops import composite, fused_mlp

    cfg, S, R, wbg, scale, ro8, vd8, z, sproj, tproj, vcontrib, gt8, trunk = \
        args
    planes = fused_mlp.planes_fwd_plain(cfg, S, R, ro8, vd8, z, sproj, tproj,
                                        vcontrib, trunk)
    out8 = composite.composite_fwd_plain(*planes, z, wbg)
    lane = torch.arange(8, device=z.device)[None, :]
    g8 = torch.where(lane < 3, 2.0 * scale * (out8 - gt8),
                     torch.where(lane == 3, 0.1 * scale * out8, 0.0))
    return list(composite.composite_bwd_plain(*planes, z, g8, wbg)[:4])


def plane_check(dev, mode: str, R: int, S: int):
    """Phase 2: plane_bwd (CUDA) in one mode vs plane_bwd_plain, every
    output, on seeded cotangent planes; its code cotangents the same bits
    over two launches."""
    import torch

    from codenerf_tpu_torch.ops import fused_train

    weight_grads, input_grads = PLANE_MODES[mode]
    cfg, args = kernel_inputs(dev, R, S)
    _, S, R, _, _, ro8, vd8, z, sproj, tproj, vcontrib, _, trunk = args
    bargs = (cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib, trunk,
             _cotangent_planes(args), weight_grads, input_grads)
    got = fused_train.plane_bwd(*bargs)
    torch.cuda.synchronize()
    terms = []
    want = fused_train.plane_bwd_plain(*bargs, sigma_terms=terms)
    names = (list(INPUT_CHAIN) if input_grads else []) + [
        "d_sproj", "d_tproj", "d_vcontrib"]
    if weight_grads:
        names += [f"{n}.{k}" for n, _, _ in fused_train.weight_shapes(cfg)
                  for k in ("w", "b")]
    scale = dict(zip(["sigma.w", "sigma.b"], terms))
    checks = []
    for name, g, w in zip(names, got, want):
        per_ray = name in INPUT_CHAIN or name.startswith("d_")
        checks.append((name, *_close(
            name, g, w, scale.get(name), per_ray=per_ray,
            slack=2.0 if name in INPUT_CHAIN else 1.0)))
    again = fused_train.plane_bwd(*bargs)
    checks += repeat_checks(names, got, again)
    del got, want, again
    err = _fail_on(checks, f"plane_bwd ({mode})")
    bnd = plane_bound(cfg, R, S, trunk.wops, weight_grads, input_grads)
    ms, plain_ms = _timings(lambda: fused_train.plane_bwd(*bargs),
                            lambda: fused_train.plane_bwd_plain(*bargs), bnd,
                            f"R={R}, S={S}")
    profile_breakdown(lambda: fused_train.plane_bwd(*bargs),
                      sequence=mode == "plane_train")
    return _entry(f"plane_bwd ({mode})", REPLACES_BWD, err, ms, plain_ms,
                  bnd)


def _composite_checks(planes, z, g8, what: str):
    """The standalone composite and its backward (CUDA) on ``planes`` (four
    (R, S) f32: densities, raw r, g, b) and depths ``z`` against their
    plain versions, white and black background, with the per-ray
    cotangent ``g8``; each mode the same bits over two launches. Returns
    the checks."""
    import torch

    from codenerf_tpu_torch.ops import composite

    checks = []
    for white in (True, False):
        fa = (*planes, z, white)
        ba = (*planes, z, g8, white)
        got = composite.composite_fwd(*fa)
        torch.cuda.synchronize()
        name = f"out8 (white_bg={white}, {what})"
        checks.append((name, *_close(name, got, composite.composite_fwd_plain(
            *fa), per_ray=True)))
        outs = composite.composite_bwd(*ba)
        want = composite.composite_bwd_plain(*ba)
        for key, g, w in zip(("gsig", "gc0", "gc1", "gc2", "dz"), outs, want):
            name = f"{key} (white_bg={white}, {what})"
            checks.append((name, *_close(name, g, w, per_ray=True)))
        ok = (torch.equal(got, composite.composite_fwd(*fa))
              and all(torch.equal(a, b) for a, b in zip(
                  outs, composite.composite_bwd(*ba))))
        log(f"  composite and its backward over two launches (white_bg="
            f"{white}, {what}): {'bit-equal' if ok else 'DIFFER'}"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append((f"two launches (white_bg={white}, {what})", 0.0, ok))
    return checks


def composite_check(dev, R: int, S: int):
    """Phase 2: the standalone composite and its backward (CUDA) vs their
    plain versions on white and black backgrounds, with a per-ray
    cotangent whose every lane, depth and acc included, is nonzero, on
    the planes of a four-plane forward; then timed."""
    import torch

    from codenerf_tpu_torch.ops import composite, fused_mlp

    cfg, args = kernel_inputs(dev, R, S)
    _, S, R, _, _, ro8, vd8, z, sproj, tproj, vcontrib, _, trunk = args
    planes = fused_mlp.planes_fwd_plain(cfg, S, R, ro8, vd8, z, sproj, tproj,
                                        vcontrib, trunk)
    gen = torch.Generator(device=dev).manual_seed(4)
    g8 = torch.randn(R, 8, generator=gen, device=dev) / (3.0 * R)
    err = _fail_on(_composite_checks(planes, z, g8, f"{R} x {S}"),
                   "composite")
    fa, ba = (*planes, z, True), (*planes, z, g8, True)
    nbytes = 5 * R * S * 4 + R * 8 * 4
    rows = {}
    for key, fn, plain, nb_ in (
            ("composite", composite.composite_fwd,
             composite.composite_fwd_plain, nbytes),
            ("composite_bwd", composite.composite_bwd,
             composite.composite_bwd_plain, nbytes + 5 * R * S * 4)):
        a = fa if key == "composite" else ba
        bnd = _bound(0, nb_)
        call_ms, plain_ms = _timings(lambda: fn(*a), lambda: plain(*a), bnd,
                                     f"R={R}, S={S}")
        # A launch this short is shorter than its wrapper's host work, so
        # events around back-to-back calls time the host: the kernel's
        # own time is its device time in the profiler's trace.
        ms = device_ms(lambda: fn(*a), "composite_kernel")
        log(f"  {key}: {ms if ms is None else f'{ms:.4f}'} ms of device "
            f"time per launch (torch.profiler), against "
            f"{call_ms:.4f} ms per call by events; "
            + ("" if ms is None else f"{bnd[0] / ms:.0%} of its byte bound"))
        rows[key] = _entry(f"{key} (standalone)", REPLACES_COMPOSITE, err,
                           call_ms if ms is None else ms, plain_ms, bnd)
    return rows


# Ragged shapes of the standalone composite: rays not a multiple of the
# rays a block, S = 39 (scalar loads, rows not 16-byte aligned), S = 128
# and S = 256 (16-byte loads; 4 and 8 samples a lane), S = 20 (twelve
# lanes without a sample), S = 1 (the last sample alone: its delta is
# 1e10 and its sigma cotangent exactly 0 on both sides).
COMPOSITE_RAGGED = ((4093, 39), (4093, 128), (1027, 256), (37, 20),
                    (37, 1))


def composite_ragged_check(dev) -> float:
    """Phase 2: :func:`_composite_checks` on seeded planes at the ragged
    shapes; returns the largest error."""
    import torch

    errs = []
    for R, S in COMPOSITE_RAGGED:
        gen = torch.Generator(device=dev).manual_seed(R + S)
        sig = torch.nn.functional.softplus(
            2.0 * torch.randn(R, S, generator=gen, device=dev))
        cs = [torch.randn(R, S, generator=gen, device=dev) for _ in range(3)]
        z = 0.8 + torch.sort(torch.rand(R, S, generator=gen, device=dev),
                             -1).values
        g8 = torch.randn(R, 8, generator=gen, device=dev) / (3.0 * R)
        errs.append(_fail_on(_composite_checks(
            (sig, *cs), z, g8, f"{R} x {S}"), "composite (ragged)"))
    return max(errs)


def _traced(fn, kernel: str, calls: int, tries: int):
    """(device µs, launches) of the CUDA kernels whose name contains
    ``kernel`` in a torch.profiler trace of ``calls`` calls, or None when
    ``tries`` traces in a row carry no device time for them or another
    number of launches than ``calls`` times a traced single call's: a
    trace on the chip machine now and then comes back without its device
    events, or without some of them (a kernel then reads faster than the
    card's memory allows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [ev for ev in prof.events()
                if ev.device_type == DeviceType.CUDA and kernel in ev.name
                and not getattr(ev, "is_user_annotation", False)]

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        per_call = len(trace(1))
        evs = trace(calls)
        us = sum(ev.time_range.elapsed_us() for ev in evs)
        if us and len(evs) == per_call * calls:
            return us, len(evs)
    return None


def device_ms(fn, kernel: str, calls: int = 20, tries: int = 3):
    """Device ms per call of the CUDA kernels whose name contains
    ``kernel`` (:func:`_traced`; None without device time)."""
    got = _traced(fn, kernel, calls, tries)
    return None if got is None else got[0] / 1e3 / calls


def kernel_ms(fn, kernel: str, what: str) -> float:
    """:func:`device_ms`, or where no trace carries the kernel's device
    time, CUDA events around 20 back-to-back calls (which then time the
    wrapper's host work too, an upper bound), said in the log."""
    ms = device_ms(fn, kernel)
    if ms is None:
        ms = time_cuda(fn, reps=20)
        log(f"  {what}: no device time in the profiler's traces; {ms:.4f} "
            f"ms per call by CUDA events (host work included)")
    return ms


def chain_check(dev, input_grads: bool, R: int, S: int):
    """Phase 2, the chain identity: the four-plane forward, the standalone
    composite, the MSE cotangent, the composite's backward and the
    plane-op backward together against the single-pass kernel on the
    same inputs — its training mode (``train``, the dW/db and code
    cotangents) or, with ``input_grads``, its pose mode (``pose``,
    d_ro8, d_vd8, d_z with the composite's dz added). The bar is
    kernel_check's mode-against-mode bar, 1e-2 of the largest magnitude
    (for the sigma head's cancelling sums, of their terms' magnitudes)."""
    import torch

    from codenerf_tpu_torch.ops import composite, fused_mlp, fused_train

    cfg, args = kernel_inputs(dev, R, S)
    _, S, R, wbg, scale, ro8, vd8, z, sproj, tproj, vcontrib, gt8, trunk = args
    planes = fused_mlp.planes_fwd(cfg, S, R, ro8, vd8, z, sproj, tproj,
                                  vcontrib, trunk)
    out8 = composite.composite_fwd(*planes, z, wbg)
    lane = torch.arange(8, device=dev)[None, :]
    diff = torch.where(lane < 3, out8 - gt8, torch.zeros_like(out8))
    se = float((diff * diff).sum())
    gp = composite.composite_bwd(*planes, z, 2.0 * scale * diff, wbg)
    chain = fused_train.plane_bwd(cfg, S, R, ro8, vd8, z, sproj, tproj,
                                  vcontrib, trunk, gp[:4], not input_grads,
                                  input_grads)
    if input_grads:
        single = fused_train.train_fused(*args, weight_grads=False,
                                         input_grads=True)
        pairs = [("se_sum", torch.tensor([se]), single[0].reshape(1)),
                 ("d_ro8", chain[0], single[-3]),
                 ("d_vd8", chain[1], single[-2]),
                 ("d_z", chain[2] + gp[4], single[-1])]
        pairs += list(zip(("d_sproj", "d_tproj", "d_vcontrib"), chain[3:6],
                          single[1:4]))
        terms = {}
        what = "pose"
    else:
        single = fused_train.train_fused(*args, weight_grads=True)
        names = ["d_sproj", "d_tproj", "d_vcontrib"] + [
            f"{n}.{k}" for n, _, _ in fused_train.weight_shapes(cfg)
            for k in ("w", "b")]
        pairs = [("se_sum", torch.tensor([se]), single[0].reshape(1))]
        pairs += list(zip(names, chain, single[1:]))
        sig_terms = []
        fused_train.train_fused_plain(*args, weight_grads=True,
                                      sigma_terms=sig_terms)
        terms = dict(zip(["sigma.w", "sigma.b"], sig_terms))
        what = "train"
    checks = []
    for name, a, b in pairs:
        a, b = a.float().to(dev), b.float()
        d = float((a - b).abs().max())
        top = (float(terms[name].max()) if name in terms
               else float(b.abs().max()))
        ok = bool(torch.isfinite(a).all()) and d <= 1e-2 * top
        log(f"  chain identity vs the single-pass {what} mode, {name}: max "
            f"abs difference {d:.3e} (scale {top:.3e})"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append((name, d, ok))
    _fail_on(checks, f"the plane-op chain vs the single-pass {what} mode")


# The launch counters of fused_step (the single pass and the plane-op
# backward), of those with weight gradients (one wgrad_kernel each) and
# of those with input gradients (one input_chain_kernel each).
STEP_MODES = ("codes", "train", "dual_codes", "dual_train", "pose",
              "pose_weights", "train_input", "train_weights", "codes_weights",
              "train_input_weights", "plane_train", "plane_codes",
              "plane_pose", "plane_train_input")
WEIGHT_MODES = tuple(m for m in STEP_MODES if "train" in m)
INPUT_MODES = tuple(m for m in STEP_MODES if "pose" in m or "input" in m)
# Shapes of input_chain_check: pose optimization's rays at the three
# sample counts of the paths, then a ragged last group (3 rays of 40
# samples a group: 2047 leaves one ray, and 120-row groups pad to 128)
# and a ray longer than a ring stage (200 samples in two chunks).
INPUT_CHAIN_SHAPES = ((R_POSE, S_FULL), (R_POSE, S_UNION),
                      (R_POSE, S_COARSE), (2047, 40), (300, 200))


def input_chain_check(dev, R: int, S: int):
    """Phase 2: the input-chain kernel alone (fused_mlp.input_chain) vs
    input_chain_plain on seeded inputs: the rays, depths and enc_xyz
    weight of a kernel call at R × S (points at which the top frequency's
    t = x·2^9 reaches the hundreds), gh0 a seeded normal plane with half
    its entries zero (as enc_xyz's ReLU mask leaves it) and a seeded
    composite dz; every output with _close's input-chain bar (slack 2),
    and d_ro8, d_vd8, d_z the same bits over two launches. Then its
    device ms against its byte bound, and torch.matmul(gh0, w_enc.T), the
    d_pe product alone, as the yardstick (never called by the port)."""
    import torch

    from codenerf_tpu_torch.ops import fused_mlp

    cfg, args = kernel_inputs(dev, R, S)
    ro8, vd8, z = args[5], args[6], args[7]
    w_enc = args[-1].wops[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    P = R * S
    gh0 = (torch.randn(P, cfg.W, generator=gen, device=dev) * 1e-3
           * (torch.rand(P, cfg.W, generator=gen, device=dev) < 0.5)
           ).to(torch.bfloat16)
    dz = torch.randn(R, S, generator=gen, device=dev) * 1e-3
    ia = (R, S, ro8, vd8, z, gh0, w_enc, dz, cfg.num_xyz_freq)
    got = fused_mlp.input_chain(*ia)
    torch.cuda.synchronize()
    want = fused_mlp.input_chain_plain(*ia)
    checks = [(f"{n} (input_chain_kernel, R={R}, S={S})", *_close(
        f"{n} (input_chain_kernel, R={R}, S={S})", g, w, per_ray=True,
        slack=2.0)) for n, g, w in zip(INPUT_CHAIN, got, want)]
    again = fused_mlp.input_chain(*ia)
    ok = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  d_ro8, d_vd8, d_z over two launches: "
        f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
    checks.append(("input chain (two launches)", 0.0, ok))
    x = (ro8[:, None, :3] + vd8[:, None, :3] * z[:, :, None]).abs().max()
    log(f"  largest |x| {float(x):.3f}: the top frequency's t reaches "
        f"{float(x) * 2 ** (cfg.num_xyz_freq - 1):.1f}")
    del got, want, again
    err = _fail_on(checks, "input_chain")
    nbytes = (P * (cfg.W * 2 + 4 * 3) + R * 8 * 4 * 4
              + w_enc.numel() * w_enc.element_size())
    bnd = _bound(2 * P * 64 * cfg.W, nbytes)
    ms = kernel_ms(lambda: fused_mlp.input_chain(*ia), "input_chain_kernel",
                   "input_chain_kernel")
    plain_ms = time_cuda(lambda: fused_mlp.input_chain_plain(*ia), reps=3)
    w_t = w_enc.t()
    lib_ms = kernel_ms(lambda: torch.matmul(gh0, w_t), "", "torch.matmul")
    log(f"  input_chain_kernel at R={R}, S={S} ({bnd[2]:.4e} FLOP, "
        f"{nbytes} B to move): {ms:.4f} ms per launch, "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); plain {plain_ms:.4f} ms; torch.matmul(gh0, w_enc.T) "
        f"{lib_ms:.4f} ms (the yardstick; the port never calls it)")
    row = _entry("input_chain_kernel (input_grads tail)", REPLACES_INPUT,
                 err, ms, plain_ms, bnd)
    row["library_ms"] = lib_ms
    return row


def plane_head_check(dev, R: int, S: int):
    """Phase 2: the four-plane head alone (fused_mlp.plane_head) on the t
    and r of a planes call at R × S (the plain forward's, on the card)
    vs plane_head_plain, each plane with _close's bar, and every plane the
    same bits over two launches. Then its device ms against its byte
    bound (t and r read, four f32 planes written: 784 B a point), and
    torch.matmul(r, w_rgb[:, :3]), the rgb product alone, as the
    yardstick (never called by the port)."""
    import torch

    from codenerf_tpu_torch.ops import fused_mlp

    cfg, args = kernel_inputs(dev, R, S)
    _, S, R, _, _, ro8, vd8, z, sproj, tproj, vcontrib, _, trunk = args
    wops = trunk.wops
    acts = fused_mlp.forward_plain(cfg, R, S, ro8, vd8, z, sproj, tproj,
                                   vcontrib, wops)
    t, r = acts["t"], acts["r"]
    del acts
    i_sig = cfg.shape_blocks + 2
    i_rgbo = cfg.shape_blocks + cfg.texture_blocks + 5
    ha = (R, S, t, r, wops[2 * i_sig], wops[2 * i_sig + 1], wops[2 * i_rgbo],
          wops[2 * i_rgbo + 1])
    got = fused_mlp.plane_head(*ha)
    torch.cuda.synchronize()
    want = fused_mlp.plane_head_plain(*ha)
    checks = [(f"{n} (plane_head_kernel)", *_close(
        f"{n} (plane_head_kernel)", g, w, per_ray=True))
        for n, g, w in zip(("sigma", "r", "g", "b"), got, want)]
    again = fused_mlp.plane_head(*ha)
    ok = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  the four planes over two launches: "
        f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
    checks.append(("planes (two launches)", 0.0, ok))
    del got, want, again
    err = _fail_on(checks, "plane_head")
    P, W = R * S, cfg.W
    nbytes = (P * (W * 2 + W + 16)
              + sum(x.numel() * x.element_size() for x in ha[4:]))
    bnd = _bound(2 * P * (W + W // 2 * 3), nbytes)
    ms = kernel_ms(lambda: fused_mlp.plane_head(*ha), "plane_head_kernel",
                   "plane_head_kernel")
    plain_ms = time_cuda(lambda: fused_mlp.plane_head_plain(*ha), reps=3)
    w_rgb3 = ha[6][:, :3]
    lib_ms = kernel_ms(lambda: torch.matmul(r, w_rgb3), "", "torch.matmul")
    log(f"  plane_head_kernel at R={R}, S={S} ({nbytes} B to move): "
        f"{ms:.4f} ms per launch, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}); plain {plain_ms:.4f} ms; "
        f"torch.matmul(r, w_rgb[:, :3]) {lib_ms:.4f} ms (the yardstick; "
        f"the port never calls it)")
    row = _entry("plane_head_kernel (four-plane head)", REPLACES_HEADS,
                 err, ms, plain_ms, bnd)
    row["library_ms"] = lib_ms
    return row


# Shapes of sigma_head_check: the hierarchical coarse pass at the
# training batch, then a P that no group of 8 points divides (2047 × 39 =
# 79,833 points: the last warp's group is ragged).
SIGMA_HEAD_SHAPES = ((R_TRAIN, S_COARSE), (2047, 39))


def sigma_head_check(dev, R: int, S: int):
    """Phase 2: the sigma-only head alone (fused_mlp.sigma_head) on the t
    of a sigma call at R × S (the plain trunk's, on the card) vs
    sigma_head_plain with _close's bar; bit-equal to the four-plane head's
    sigma plane on the same t (fused_mlp.plane_head, with a seeded r) and
    over two launches. Then its device ms against its byte bound (t read,
    sigma written: 516 B a point) and torch.matmul(t, w_sig), the product
    alone, as the yardstick (never called by the port)."""
    import torch

    from codenerf_tpu_torch.ops import fused_mlp

    cfg, args = kernel_inputs(dev, R, S)
    _, S, R, _, _, ro8, vd8, z, sproj, _, _, _, trunk = args
    wops = trunk.wops
    t = fused_mlp.shape_trunk_plain(cfg, R, S, ro8, vd8, z, sproj,
                                    wops)["t"]
    i_sig = cfg.shape_blocks + 2
    i_rgbo = cfg.shape_blocks + cfg.texture_blocks + 5
    ha = (R, S, t, wops[2 * i_sig], wops[2 * i_sig + 1])
    what = f"sigma (sigma_head_kernel, R={R}, S={S})"
    got = fused_mlp.sigma_head(*ha)
    torch.cuda.synchronize()
    want = fused_mlp.sigma_head_plain(*ha)
    checks = [(what, *_close(what, got, want, per_ray=True))]
    P, W = R * S, cfg.W
    gen = torch.Generator(device=dev).manual_seed(6)
    r = torch.randn(P, W // 2, generator=gen, device=dev).to(torch.bfloat16)
    planes = fused_mlp.plane_head(R, S, t, r, *ha[3:], wops[2 * i_rgbo],
                                  wops[2 * i_rgbo + 1])
    again = fused_mlp.sigma_head(*ha)
    for name, other in (("the four-plane head's sigma plane", planes[0]),
                        ("a second launch", again)):
        ok = torch.equal(got, other)
        log(f"  sigma vs {name} on the same t: "
            f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
        checks.append((f"sigma (vs {name})", 0.0, ok))
    del got, want, planes, again, r
    err = _fail_on(checks, "sigma_head")
    bnd = _bound(2 * P * W, P * (2 * W + 4) + 4 * (W + 1))
    ms = kernel_ms(lambda: fused_mlp.sigma_head(*ha), "sigma_head_kernel",
                   "sigma_head_kernel")
    plain_ms = time_cuda(lambda: fused_mlp.sigma_head_plain(*ha), reps=3)
    w_sig = ha[3].to(torch.bfloat16)
    lib_ms = kernel_ms(lambda: torch.matmul(t, w_sig), "", "torch.matmul")
    log(f"  sigma_head_kernel at R={R}, S={S} ({bnd[3]} B to move): "
        f"{ms:.4f} ms per launch, {bnd[3] / (ms * 1e-3) / 1e9:.1f} GB/s; "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}); plain {plain_ms:.4f} ms; "
        f"torch.matmul(t, w_sig) {lib_ms:.4f} ms (the yardstick, no "
        f"softplus; the port never calls it)")
    row = _entry("sigma_head_kernel (sigma-only head)", REPLACES_SIGMA_HEAD,
                 err, ms, plain_ms, bnd)
    row["library_ms"] = lib_ms
    return row


def fold_bytes(R: int, S: int, C: int) -> int:
    """The bytes ray_sum_fold_kernel must move at R × S: each partial row
    a ray adds read once (one per 16-point slice it touches, 4 B a value),
    every output written once (2 B)."""
    rows = sum((r * S + S - 1) // 16 - r * S // 16 + 1 for r in range(R))
    return 4 * C * rows + 2 * C * R


FOLD_SHAPES = ((R_TRAIN, S_FULL), (R_CODES, S_UNION), (33, 200))


def fold_check(dev, R: int, S: int):
    """Phase 2: the code cotangents' last pass alone
    (fused_train.fold_ray_sums) on seeded f32 spans laid out as the dx
    kernel leaves them at R × S: the rays' span (R × (nb + nt + 1) × W)
    and the slices' rows (fused_train.slice_rows(R, S) rows), values of
    magnitudes e^-12 to e^12 times a normal draw, the head of each
    section of the rays' span exact rounding ties (both directions), ±0,
    subnormals and values near and past the bf16 maximum: each of the
    three outputs bit-equal to fold_ray_sums_plain's (the same additions
    in the same order, then x.to(torch.bfloat16); compared as 16-bit
    integers, so -0 is not 0), one launch a call. Then its device ms
    against its byte bound (fold_bytes) and, as a yardstick, one
    x.to(torch.bfloat16) of the rays' span (the rounding alone: no single
    PyTorch call adds the rows, so the row's library_ms is null; the port
    never calls it)."""
    import numpy as np
    import torch

    from codenerf_tpu_torch.config import NetConfig
    from codenerf_tpu_torch.ops import fused_train

    cfg = NetConfig()
    nb, nt, W = cfg.shape_blocks, cfg.texture_blocks, cfg.W
    C = (nb + nt + 1) * W
    n, n_sl = R * C, fused_train.slice_rows(R, S) * C
    gen = torch.Generator(device=dev).manual_seed(7)

    def draw(k):
        return (torch.randn(k, generator=gen, device=dev) * torch.exp(
            torch.rand(k, generator=gen, device=dev) * 24.0 - 12.0))

    span, slices = draw(n), draw(n_sl)
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x00008000,
                     0x00018000, 0x7F7E8000, 0x7F7F8000], np.uint32)
    special = torch.from_numpy(np.concatenate([ties.view(np.float32), np.array(
        [0.0, -0.0, 1e-40, -1e-40, 2.0 ** -126, 3.3895e38, -3.3895e38,
         3.4e38, np.finfo(np.float32).max], np.float32)])).to(dev)
    for start in (0, R * nb * W, R * (nb + nt) * W):
        span[start:start + special.numel()] = special
    sa = (span, slices, R, S, nb, nt, W)
    before = fused_train.fold_ray_sums.launches
    got = fused_train.fold_ray_sums(*sa)
    torch.cuda.synchronize()
    want = fused_train.fold_ray_sums_plain(*sa)
    checks = []
    for name, g, w in zip(("d_sproj", "d_tproj", "d_vcontrib"), got, want):
        ok = g.shape == w.shape and torch.equal(g.view(torch.int16),
                                                w.view(torch.int16))
        log(f"  {name} {tuple(g.shape)} (ray_sum_fold_kernel, R={R}, "
            f"S={S}) vs fold_ray_sums_plain: "
            f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
        checks.append((name, 0.0, ok))
    launches = fused_train.fold_ray_sums.launches - before
    checks.append(("one launch a call", 0.0, launches == 1))
    del got, want
    err = _fail_on(checks, "fold_ray_sums")
    nbytes = fold_bytes(R, S, C)
    bnd = _bound(0, nbytes)
    ms = kernel_ms(lambda: fused_train.fold_ray_sums(*sa),
                   "ray_sum_fold_kernel", "ray_sum_fold_kernel")
    plain_ms = time_cuda(lambda: fused_train.fold_ray_sums_plain(*sa),
                         reps=3)
    lib_ms = kernel_ms(lambda: span.to(torch.bfloat16), "",
                       "x.to(torch.bfloat16)")
    log(f"  ray_sum_fold_kernel at R={R}, S={S} ({n} values out, {nbytes} B "
        f"to move): {ms:.4f} ms per launch, "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); plain {plain_ms:.4f} ms; x.to(torch.bfloat16) of the "
        f"rays' span {lib_ms:.4f} ms (the yardstick; the port never calls "
        f"it)")
    return _entry("ray_sum_fold_kernel (code cotangents: fixed-order ray "
                  "sums, to bf16)", REPLACES_FOLD, err, ms, plain_ms, bnd)


# (objects, rays, how the rays pick their objects) of the code tables'
# gradient's phase-2 cases: chip_smoke's 4 training objects, 16, and
# cars_train's 2,458, uniformly; then a ragged batch (not a multiple of
# code_rows.TILE) whose even objects have no rays and one of whose objects
# holds half of them.
CODE_ROW_CASES = ((4, R_TRAIN, "uniform"), (16, R_TRAIN, "uniform"),
                  (2458, R_TRAIN, "uniform"), (37, R_TRAIN - 45, "ragged"))


def code_rows_bytes(R: int, n_rows: int, D: int) -> int:
    """The bytes code_row_sums must move: each cotangent read once (4 B a
    value), the table gradient written once, the order read once (int32
    perm and sorted_obj 4 B a ray each, offsets 4 B a row)."""
    return 4 * R * D + 4 * n_rows * D + 8 * R + 4 * (n_rows + 1)


def code_rows_check(dev) -> dict:
    """Phase 2: the code tables' gradient alone (``code_rows.
    code_row_sums``: ``code_row_tiles_kernel`` + ``code_row_fold_kernel``)
    on seeded normal cotangents of R × 512 columns (both tables' width)
    for each of ``CODE_ROW_CASES``: bit-equal to ``code_row_sums_plain``
    (the same additions in the same order) and over two launches, one
    counted launch a call; its device ms against its byte bound
    (``code_rows_bytes``), the plain version's ms, and as yardsticks
    ``index_add_`` (what ``index_select``'s backward runs, with atomics)
    and ``index_put_(accumulate=True)`` (the deterministic library route)
    of the same rows into a zeroed table. The row's numbers are the
    4-object case's, the phase-3 training shape."""
    import torch

    from codenerf_tpu_torch.ops import code_rows

    row = None
    for n_rows, R, how in CODE_ROW_CASES:
        gen = torch.Generator(device=dev).manual_seed(11 + n_rows)
        if how == "uniform":
            obj = torch.randint(0, n_rows, (R,), generator=gen, device=dev)
        else:
            odd = torch.arange(1, n_rows, 2, device=dev)
            obj = odd[torch.randint(0, odd.numel(), (R,), generator=gen,
                                    device=dev)]
            obj[torch.rand(R, generator=gen, device=dev) < 0.5] = 5
        g = torch.randn(R, D_CODES, generator=gen, device=dev)
        order = code_rows.RowOrder.of(obj, n_rows)
        before = code_rows.launches["code_rows"]
        got = code_rows.code_row_sums(g, order, n_rows)
        again = code_rows.code_row_sums(g, order, n_rows)
        torch.cuda.synchronize()
        want = code_rows.code_row_sums_plain(g, order, n_rows)
        empty = int((order.offsets[1:] == order.offsets[:-1]).sum())
        checks = [
            ("vs code_row_sums_plain", 0.0, torch.equal(got, want)),
            ("two launches", 0.0, torch.equal(got, again)),
            ("one launch a call", 0.0,
             code_rows.launches["code_rows"] - before == 2)]
        what = (f"{n_rows} objects ({empty} without rays), R={R}, "
                f"D={D_CODES}")
        for name, _, ok in checks:
            log(f"  code_row_sums at {what}: {name} "
                f"{'bit-equal' if ok else 'DIFFERS'}"
                f"{'' if ok else '  <-- FAILS'}")
        _fail_on(checks, f"code_row_sums at {what}")
        err = float((got - want).abs().max())
        lib = torch.zeros(n_rows, D_CODES, device=dev).index_add_(0, obj, g)
        lib_err = float((got - lib).abs().max())
        nbytes = code_rows_bytes(R, n_rows, D_CODES)
        bnd = _bound(0, nbytes)
        ms = kernel_ms(lambda: code_rows.code_row_sums(g, order, n_rows),
                       "code_row_", "code_row_sums")
        plain_ms = time_cuda(
            lambda: code_rows.code_row_sums_plain(g, order, n_rows), reps=3)
        zero = torch.zeros(n_rows, D_CODES, device=dev)
        add_ms = time_cuda(lambda: zero.zero_().index_add_(0, obj, g), 20)
        put_ms = time_cuda(lambda: zero.zero_().index_put_(
            (obj,), g, accumulate=True), 20)
        order_ms = time_cuda(lambda: code_rows.RowOrder.of(obj, n_rows), 20)
        log(f"  code_row_sums at {what} ({nbytes} B to move): {ms:.4f} ms "
            f"per call (device), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}); plain {plain_ms:.4f} ms; "
            f"largest difference from index_add_ {lib_err:.3e}; yardsticks "
            f"(CUDA events, a zeroing included): index_add_ {add_ms:.4f} "
            f"ms, index_put_(accumulate=True) {put_ms:.4f} ms; the order "
            f"(RowOrder.of, shared by both tables) {order_ms:.4f} ms")
        if row is None:
            row = _entry("code_row_tiles_kernel + code_row_fold_kernel (the "
                         "code tables' gradient: fixed-order row sums)",
                         REPLACES_CODE_ROWS, err, ms, plain_ms, bnd)
            row.update(source=SOURCE_CODE_ROWS, library_ms=add_ms)
        del got, again, want, g
    return row


def small_kernel_rates(dev) -> dict:
    """Phase 2: the device ms of the port's small kernels at the main
    paths' shapes, beside their byte bounds: sigma_head_kernel in
    sigma_fwd at 16,384 × 32 (t read, sigma written), ray_sum_fold_kernel
    per training call at 16,384 × 96 (the per-ray cotangent sums:
    fold_bytes, f32 in, bf16 out), which must launch once a call, and
    pack_kernel alone (``fused_train.pack_trunk_weights``: every trunk
    weight read once, its packed forward and dx operands written), which a
    training call on packed operands, as the main paths make them, must
    not launch. A kernel without device time in the traces reads "not
    measured". Returns pack_kernel's row."""
    from codenerf_tpu_torch.ops import fused_mlp, fused_train

    out = {}
    cfg, args = kernel_inputs(dev, R_TRAIN, S_COARSE)
    _, S, R, _, _, ro8, vd8, z, sproj, tproj, vcontrib, _, trunk = args
    sargs = (cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib, trunk)
    P, W = R * S, cfg.W
    out["sigma_head_kernel"] = (
        device_ms(lambda: fused_mlp.sigma_fwd(*sargs), "sigma_head_kernel"),
        P * (2 * W + 4) / PEAK_HBM_BYTES * 1e3)
    cfg, args = kernel_inputs(dev, R_TRAIN, S_FULL)
    wops = args[-1].wops
    pack = lambda: fused_train.pack_trunk_weights(cfg, wops)
    call = lambda: fused_train.train_fused(*args, weight_grads=True)
    C = (cfg.shape_blocks + cfg.texture_blocks + 1) * cfg.W
    traced = _traced(call, "ray_sum_fold_kernel", calls=3, tries=3)
    if traced is not None and traced[1] != 3:
        raise AssertionError(f"ray_sum_fold_kernel launched {traced[1]} "
                             f"times in 3 training calls, not once a call")
    out["ray_sum_fold_kernel"] = (
        None if traced is None else traced[0] / 1e3 / 3,
        fold_bytes(R_TRAIN, S_FULL, C) / PEAK_HBM_BYTES * 1e3)
    packs = _traced(call, "pack_kernel", calls=3, tries=1)
    if packs is not None:
        raise AssertionError(f"training calls on packed operands launched "
                             f"pack_kernel {packs[1]} times")
    n_in = sum(wops[2 * i].numel()
               for i in fused_train.trunk_layer_indices(cfg))
    n_out = fused_train.library().packed_trunk_elems(
        cfg.W, cfg.shape_blocks, cfg.texture_blocks)
    bnd = _bound(0, 2 * (n_in + n_out))
    out["pack_kernel"] = (kernel_ms(pack, "pack_kernel", "pack_kernel"),
                          bnd[0])
    plain_ms = time_cuda(
        lambda: fused_train.pack_trunk_weights_plain(cfg, wops), reps=3)
    for k, (ms, b) in out.items():
        log(f"  {k} " + ("alone" if k == "pack_kernel" else "in its caller")
            + ": " + ("not measured" if ms is None else f"{ms:.4f} ms per "
                      f"call ({b / ms:.0%} of its bound)")
            + f", byte bound {b:.4f} ms"
            + (", one launch a call" if k == "ray_sum_fold_kernel"
               and traced is not None else ""))
    log(f"  pack_kernel: plain version (wgmma_pack per operand) "
        f"{plain_ms:.4f} ms")
    return _entry("pack_kernel (trunk weights, once per weight version)",
                  REPLACES, 0.0, out["pack_kernel"][0], plain_ms, bnd)


def trunk_rates(cfg, R: int, S: int, fn, weight_grads: bool) -> None:
    """One line per trunk kernel: device ms per launch (torch.profiler),
    TFLOP/s of its matmuls in ``fn``'s call at R × S, and its bound: the
    larger of its matmuls at the bf16 peak and the bytes a point must move
    at the HBM rate. The forward writes t, r and the ReLU-mask bit planes
    (32 B each), in training also every dW input (the PE, the injected
    inputs, the last shape and texture outputs) and enc_xyz's mask; the
    dx chain reads the rgb_hidden cotangent, dsig and the masks, and in
    training writes every gh plane."""
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    P = R * S
    masks = (nb + nt + 1 + weight_grads) * 32
    fwd_b = 4 + 2 * W + W + masks
    dx_b = W + 4 + masks
    if weight_grads:
        fwd_b += 2 * 64 + 2 * W * (nb + nt + 2)
        dx_b += 2 * W * (nb + nt + 3)
    work = {"trunk_fwd_kernel": (2 * P * (64 * W + W * W * (nb + nt + 2)
                                          + W * W // 2), P * fwd_b),
            "trunk_dx_kernel": (2 * P * (W * W * (nb + nt + 2)
                                         + W * W // 2), P * dx_b)}
    for name, (f, nbytes) in work.items():
        ms = device_ms(fn, name, calls=5)
        bnd = _bound(f, nbytes)
        rate = "not measured" if ms is None else \
            f"{ms:.4f} ms per launch, {f / (ms * 1e-3) / 1e12:.1f} TFLOP/s"
        log(f"  {name} at R={R}, S={S} ({f:.4e} FLOP, {nbytes} B to move): "
            f"{rate} ({PEAK_BF16_FLOPS / 1e12:.0f} peak); bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")


def head_dw_rates(cfg, R: int, S: int, fn, weight_grads: bool) -> None:
    """One line each, from ``fn``'s call at R × S (torch.profiler): the
    head kernel's device ms per launch and GB/s against the bytes the head
    must move — t and r read once (768 B a point at W=256), g_r and dsig
    written (260 B), z, gt8 and se8 (and rgb8 or the head's rows) — and
    with weight gradients the dW kernel's ms, TFLOP/s and GB/s against the
    planes it reads (7,552 B a point), and its fixed-order sum's ms against
    that sum's byte bound: every point split's f32 partials of every
    trunk layer and the head kernel's rows read once, every dW/db written
    once."""
    import ctypes

    from codenerf_tpu_torch.ops import fused_train

    W, P = cfg.W, R * S
    nbytes = P * (W * 2 + W + W + 4) + P * 4 + R * 32 * 2
    if weight_grads:
        nbytes += (R + 7) // 8 * (W + W // 2 * 8 + 16) * 4
    ms = device_ms(fn, "head_kernel", calls=5)
    rate = "not measured" if ms is None else \
        f"{ms:.4f} ms per launch, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s"
    log(f"  head_kernel at R={R}, S={S} ({nbytes} B to move, "
        f"{nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms at "
        f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s): {rate}")
    if not weight_grads:
        return
    nb, nt = cfg.shape_blocks, cfg.texture_blocks
    flops = 2 * P * (64 * W + W * W * (nb + nt + 2) + W * W // 2)
    planes = P * 2 * ((64 + W) + (nb + nt + 2) * 2 * W + (W + W // 2))
    ms = device_ms(fn, "wgrad_kernel", calls=5)
    sum_ms = device_ms(fn, "fixed_sum_kernel", calls=5)
    rate = "not measured" if ms is None else (
        f"{ms:.4f} ms per launch, {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{planes / (ms * 1e-3) / 1e9:.1f} GB/s")
    shapes = [fused_train.weight_shapes(cfg)[i][1]
              for i in fused_train.trunk_layer_indices(cfg)]
    ms_, ns_ = ((ctypes.c_int * len(shapes))(*[x[k] for x in shapes])
                for k in (0, 1))
    sum_bytes = 4 * (fused_train.library().weight_grads_workspace(
        ms_, ns_, len(shapes), P) + (R + 7) // 8 * (W + W // 2 * 8 + 16)
        + sum(math.prod(w) + math.prod(b)
              for _, w, b in fused_train.weight_shapes(cfg)))
    log(f"  wgrad_kernel at R={R}, S={S} ({flops:.4e} FLOP, {planes} B of "
        f"planes; byte floor {planes / PEAK_HBM_BYTES * 1e3:.4f} ms): "
        f"{rate}; fixed_sum_kernel "
        f"{'not measured' if sum_ms is None else f'{sum_ms:.4f} ms'} "
        f"({sum_bytes} B to move: bound "
        f"{sum_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms, bytes)")


def wgrad_check(dev):
    """Phase 2: the weight-gradient kernel alone (fused_train.weight_grads:
    one wgrad_kernel and one fixed_sum_kernel launch for every pair) on
    the planes of one training-shape call — each trunk layer's bf16 input
    and output cotangent at 16,384 × 96, from the plain chain on the card,
    in fused_step's order — against weight_grads_plain, every layer, with
    _close's bar; dW/db the same bits over two calls. Then its device ms,
    TFLOP/s and GB/s against the byte floor, and as its yardstick
    torch.matmul(X.t(), G) over the same pairs (never called by the
    port). Returns the kernel's ms per launch and the yardstick's."""
    import torch

    from codenerf_tpu_torch.ops import fused_mlp, fused_train

    cfg, args = kernel_inputs(dev, R_TRAIN, S_FULL)
    _, S, R, wbg, scale, ro8, vd8, z, sproj, tproj, vcontrib, gt8, trunk = args
    wops = trunk.wops
    acts = fused_mlp.forward_plain(cfg, R, S, ro8, vd8, z, sproj, tproj,
                                   vcontrib, wops)
    _, _, _, g_sigma, g_rgb, _ = fused_train.head_plain(
        R, S, acts["sig_pre"], acts["rgb"], z, gt8, wbg, scale)
    named = []
    fused_train.backward_chain_plain(cfg, R, S, acts, sproj, tproj, wops,
                                     g_sigma, g_rgb, True, False,
                                     pairs=named)
    del acts, g_sigma, g_rgb
    by_name = {n: (x, g) for n, x, g in named}
    names = (["rgb_hidden"]
             + [f"texture_{k}" for k in range(cfg.texture_blocks)]
             + ["enc_viewdir_pt", "enc_shape"]
             + [f"shape_{k}" for k in range(cfg.shape_blocks)] + ["enc_xyz"])
    pairs = [by_name[n] for n in names]
    del named, by_name
    torch.cuda.empty_cache()
    got = fused_train.weight_grads(pairs)
    torch.cuda.synchronize()
    again = fused_train.weight_grads(pairs)
    want = fused_train.weight_grads_plain(pairs)
    checks = []
    for n, g, w in zip(names, got, want):
        for k in (0, 1):
            name = f"{n}.{'wb'[k]} (wgrad_kernel)"
            checks.append((name, *_close(name, g[k], w[k])))
    ok = all(torch.equal(a[k], b[k]) for a, b in zip(got, again)
             for k in (0, 1))
    log(f"  wgrad_kernel dW/db over two calls: "
        f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
    checks.append(("dW/db (two calls)", 0.0, ok))
    del got, again, want
    _fail_on(checks, "wgrad_kernel")
    P = R * S
    flops = sum(2 * P * x.shape[1] * g.shape[1] for x, g in pairs)
    nbytes = sum(2 * P * (x.shape[1] + g.shape[1]) for x, g in pairs)
    ms = device_ms(lambda: fused_train.weight_grads(pairs), "wgrad_kernel",
                   calls=5)
    sum_ms = device_ms(lambda: fused_train.weight_grads(pairs),
                       "fixed_sum_kernel", calls=5)
    lib_ms = time_cuda(lambda: [torch.matmul(x.t(), g) for x, g in pairs],
                       reps=5)
    log(f"  wgrad_kernel alone at R={R}, S={S} ({len(pairs)} layers, "
        f"{flops:.4e} FLOP, {nbytes} B of planes, byte floor "
        f"{nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms at "
        f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s): "
        + ("not measured" if ms is None else
           f"{ms:.4f} ms per launch, {flops / (ms * 1e-3) / 1e12:.1f} "
           f"TFLOP/s, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        + f"; fixed_sum_kernel "
        + ("not measured" if sum_ms is None else f"{sum_ms:.4f} ms")
        + f"; torch.matmul(X.t(), G) over the same pairs {lib_ms:.4f} ms "
        f"(the yardstick; the port never calls it)")
    return ms, lib_ms


def pack_check(dev) -> None:
    """Phase 2: the CUDA weight packer against its plain version
    (fused_train.pack_trunk_weights_plain), bit for bit."""
    import torch

    from codenerf_tpu_torch.ops import fused_train

    cfg, args = kernel_inputs(dev, 16, 8)
    wops = args[-1].wops
    got = fused_train.pack_trunk_weights(cfg, wops)
    want = fused_train.pack_trunk_weights_plain(cfg, wops)
    ok = torch.equal(got.view(torch.int16), want.view(torch.int16))
    log(f"  packed trunk weights ({got.numel()} bf16) vs the plain packing: "
        f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
    if not ok:
        raise AssertionError("pack_kernel disagrees with wgmma_pack")


def staleness_check(dev) -> None:
    """Phase 2: the packed-operand cache across a weight update. A
    full-width network's operands are cached (``trunk_operands``), then
    one fused AdamW step through ``train_step.apply_update`` changes the
    weights (a fused step leaves the parameters' versions as they were:
    only apply_update's drop makes the next read miss). On the rebuilt
    operands a training call (4096 × 96) must give every output of the
    same call on a buffer freshly packed from the new weights (squared
    error, code cotangents, dW/db) bit for bit, and a pose call (2048 ×
    96) likewise (with ``d_ro8``, ``d_vd8`` and ``d_z``). The rebuilt packing must equal
    ``pack_trunk_weights_plain`` of the new weights, and the same calls
    on the packing from before the step must differ (the check can see a
    stale buffer)."""
    import torch
    from torch import nn

    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.ops import fused_train
    from codenerf_tpu_torch.training import train_step
    from codenerf_tpu_torch.training.state import TrainState

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jsonfiles", "srncar_fused.json")) as f:
        hp = hparams_from_dict(json.load(f))
    cfg = hp.net
    gen = torch.Generator(device=dev).manual_seed(5)
    model = CodeNeRF(cfg, generator=gen, device=dev)
    codes = [nn.Parameter(torch.zeros(2, cfg.latent_dim, device=dev))
             for _ in range(2)]
    state = TrainState(model=model, shape_codes=codes[0],
                       texture_codes=codes[1], generator=gen,
                       optimizer=torch.optim.AdamW(model.parameters(),
                                                   lr=1e-3, fused=True))
    before = fused_train.trunk_operands(model, cfg)
    old_packed = before.packed.clone()
    for p in model.parameters():
        p.grad = 1e-2 * torch.randn(p.shape, generator=gen, device=dev)
    train_step.apply_update(state, hp)
    trunk = fused_train.trunk_operands(model, cfg)
    plain = fused_train.pack_trunk_weights_plain(cfg, trunk.wops)
    checks = [("a rebuild after the update", 0.0, trunk is not before),
              ("the rebuilt packing vs the plain one", 0.0, torch.equal(
                  trunk.packed.view(torch.int16), plain.view(torch.int16)))]
    stale = fused_train.TrunkOperands(trunk.wops, old_packed)
    fresh_trunk = fused_train.fresh_trunk_operands(
        cfg, fused_train.flatten_params(model, cfg))

    for what, (R, S), kw in (
            ("training", (R_CODES, S_FULL), dict(weight_grads=True)),
            ("pose", (R_POSE, S_FULL), dict(weight_grads=False,
                                             input_grads=True))):
        args = kernel_inputs(dev, R, S)[1][:-1]
        cached = fused_train.train_fused(*args, trunk, **kw)
        fresh = fused_train.train_fused(*args, fresh_trunk, **kw)
        old = fused_train.train_fused(*args, stale, **kw)
        torch.cuda.synchronize()
        checks.append((f"{what}: cached vs freshly packed, bit for bit", 0.0,
                       all(torch.equal(a, b) for a, b in zip(cached, fresh))))
        checks.append((f"{what}: the packing from before the update "
                       f"differs", 0.0, not all(torch.equal(a, b) for a, b in
                                               zip(old, fresh))))
        del cached, fresh, old
    for name, d, ok in checks:
        log(f"  staleness: {name}: {'holds' if ok else 'FAILS'}"
            + (f" (max abs difference {d:.3e})" if d else ""))
    _fail_on(checks, "the packed-operand cache")
    _operand_host_cost(model, cfg, dev)


def _operand_host_cost(model, cfg, dev, n: int = 200) -> None:
    """Host µs per call of what a kernel call spends on its weights: a
    cache hit (``trunk_operands``, the key walk over every parameter), the
    CUDA calls' check of the operands (``_cuda_trunk``, made by every
    launch), and a fresh build (``flatten_params``, the casts and one
    pack), which each call made before the cache; host clock over ``n``
    calls, one synchronize after."""
    import torch

    from codenerf_tpu_torch.ops import fused_train

    trunk = fused_train.trunk_operands(model, cfg)
    fns = {"trunk_operands (hit)": lambda: fused_train.trunk_operands(
               model, cfg),
           "_cuda_trunk (the check)": lambda: fused_train._cuda_trunk(
               cfg, trunk, dev),
           "a fresh build (flatten, casts, pack)":
               lambda: fused_train.fresh_trunk_operands(
                   cfg, fused_train.flatten_params(model, cfg))}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        log(f"  host cost per call, {name}: "
            f"{(time.perf_counter() - t0) / n * 1e6:.1f} µs")


PAIRS = {   # launch counter: the flag pair no path calls, and its shape
    "train_input": (dict(weight_grads=True, input_grads=True), R_CODES,
                    S_COARSE),
    "train_weights": (dict(weight_grads=True, want_weights=True), R_TRAIN,
                      S_COARSE)}


def pair_check(dev, mode: str):
    """Phase 2: a flag pair of the single pass that no path calls (CUDA) vs
    train_fused_plain, every output; it only adds outputs to the
    weight-gradient mode, so on the same inputs its dW/db are that mode's
    bits and its SE and code cotangents that mode's within 1e-2 of the
    largest magnitude; the code cotangents and d_ro8, d_vd8, d_z the same
    bits over two launches."""
    import torch

    from codenerf_tpu_torch.ops import fused_train

    kw, R, S = PAIRS[mode]
    cfg, args = kernel_inputs(dev, R, S)
    got = fused_train.train_fused(*args, **kw)
    torch.cuda.synchronize()
    terms = []
    want = fused_train.train_fused_plain(*args, sigma_terms=terms, **kw)
    ig, ww = kw.get("input_grads", False), kw.get("want_weights", False)
    wnames = [f"{n}.{k}" for n, _, _ in fused_train.weight_shapes(cfg)
              for k in ("w", "b")]
    names = (["se_sum", "d_sproj", "d_tproj", "d_vcontrib"]
             + ["weights"] * ww + list(INPUT_CHAIN) * ig + wnames)
    scale = dict(zip(["sigma.w", "sigma.b"], terms))
    checks = []
    for name, g, w in zip(names, got, want):
        if name == "se_sum":
            g, w = g.reshape(1), w.reshape(1)
        checks.append((name, *_close(
            name, g, w, scale.get(name), per_ray=name.startswith(
                ("d_", "weights")),
            slack=2.0 if name in INPUT_CHAIN else 1.0)))
    base = fused_train.train_fused(*args, weight_grads=True)
    n_extra = len(got) - len(base)
    for name, a, b in zip(names[:4], got[:4], base[:4]):
        d = float((a.float() - b.float()).abs().max())
        ok = d <= 1e-2 * float(b.float().abs().max())
        log(f"  {name}: {mode} vs the weight-gradient mode, max abs "
            f"difference {d:.3e}{'' if ok else '  <-- FAILS'}")
        checks.append((f"{name} (vs train mode)", d, ok))
    ok = all(torch.equal(a, b) for a, b in zip(got[4 + n_extra:], base[4:]))
    log(f"  dW/db vs the weight-gradient mode: "
        f"{'bit-equal' if ok else 'DIFFER'}{'' if ok else '  <-- FAILS'}")
    checks.append(("dW/db (vs train mode)", 0.0, ok))
    again = fused_train.train_fused(*args, **kw)
    checks += repeat_checks(names, got, again)
    if ig:
        for k, name in enumerate(INPUT_CHAIN):
            i = 4 + ww + k
            ok = torch.equal(got[i], again[i])
            log(f"  {name}: two launches {'bit-equal' if ok else 'DIFFER'}"
                f"{'' if ok else '  <-- FAILS'}")
            checks.append((f"{name} (two launches)", 0.0, ok))
    del got, want, base, again
    err = _fail_on(checks, f"train_fused ({mode})")
    bnd = bound(cfg, R, S, args[-1].wops, True, input_grads=ig,
                want_weights=ww)
    ms, plain_ms = _timings(lambda: fused_train.train_fused(*args, **kw),
                            lambda: fused_train.train_fused_plain(*args,
                                                                  **kw),
                            bnd, f"R={R}, S={S}")
    flags = ", ".join(k for k in kw)
    return {"name": f"train_fused ({flags})", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def profile_breakdown(fn, sequence: bool = False) -> None:
    """Device time per CUDA kernel name over three calls (torch.profiler);
    prints 'not measured' when the trace carries no device time. With
    ``sequence``, also each device kernel of the last call in launch
    order, with its ms (one layer per GEMM launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.key and not ev.key.startswith(("cuda", "aten::")):
            rows.append((dev_us / 3.0 / 1e3, ev.count // 3, ev.key))
    if not rows:
        log("  profile: device time per kernel not measured (no CUDA "
            "events in the trace)")
        return
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        log(f"  profile: {ms:.4f} ms/call in {n} launch(es) of {key[:90]}")
    if sequence:
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        evs = evs[len(evs) - len(evs) // 3:]
        log("  profile, one call in launch order (ms): " + ", ".join(
            f"{_short(ev.name)} {ev.time_range.elapsed_us() / 1e3:.3f}"
            for ev in evs))


def _short(name: str) -> str:
    return name.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0]


# The __global__ functions of ops/csrc/*.cu. PyTorch names some of its
# own kernels in anonymous namespaces too, so the port's are told apart
# by name.
PORT_KERNELS = ("trunk_fwd_kernel", "trunk_dx_kernel", "pack_kernel",
                "wgrad_kernel", "head_kernel", "fixed_sum_kernel",
                "ray_sum_fold_kernel", "sigma_head_kernel",
                "input_chain_kernel", "plane_head_kernel",
                "composite_kernel", "code_row_tiles_kernel",
                "code_row_fold_kernel")
# PyTorch's index_add_ (index_select's backward, f32 atomics) by its op
# and kernel names: no step may run it.
ATOMIC_ROW_SUMS = ("indexFuncSmallIndex", "indexFuncLargeIndex", "index_add")


def log_step_profile(what: str, untraced_ms: float, wall_ms: float, prof,
                     steps: int, packs_per_step: int = 0) -> dict:
    """Wall ms per step untraced and traced, device-busy ms in the traced
    window split into the port's kernels and PyTorch's, the idle share
    against each wall, the device ms per step of the largest kernels by
    name (port or PyTorch), and the port's launches per step by name. The
    tracer spaces kernels apart and slows the host, so the idle share
    against the untraced wall is the step's own. The window must hold
    ``packs_per_step`` pack_kernel launches a step: one per network and
    training step, none in a frozen step (the weights are packed once per
    version). Returns the port's launches in the window by name."""
    from torch.autograd import DeviceType

    ours, other, by_name, count = 0.0, 0.0, {}, {}
    atomic = sorted({ev.name[:80] for ev in prof.events()
                     if any(k in ev.name for k in ATOMIC_ROW_SUMS)})
    if atomic:
        raise AssertionError(f"{what}: the step runs {atomic}")
    for ev in prof.events():
        # User annotations (e.g. ``Optimizer.step#AdamW.step``) are ranges
        # on the device timeline that overlap the kernels they enclose.
        if ev.device_type != DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        ms = ev.time_range.elapsed_us() / 1e3 / steps
        name = _short(ev.name)[:60]
        by_name[name] = by_name.get(name, 0.0) + ms
        if name.split("<")[0] in PORT_KERNELS:
            ours += ms
            count[name] = count.get(name, 0) + 1
        else:
            other += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = ours + other
    log(f"  {what} step profile: {untraced_ms:.3f} ms wall per step "
        f"untraced, {wall_ms:.3f} traced; device busy {busy:.3f} ms (port "
        f"kernels {ours:.3f}, PyTorch kernels {other:.3f}); device idle "
        f"share {max(0.0, 1.0 - busy / untraced_ms):.3f} of the untraced "
        f"wall, {max(0.0, 1.0 - busy / wall_ms):.3f} of the traced; "
        f"largest kernels (ms/step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in top)
        + "; the port's launches per step: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in sorted(count.items()))
        + "; no index_add_")
    packs = count.get("pack_kernel", 0)
    if packs != packs_per_step * steps:
        raise AssertionError(f"{what}: {packs} pack_kernel launches in "
                             f"{steps} profiled steps, expected "
                             f"{packs_per_step} a step")
    return count


def write_dataset(root: str, split: str, n_objs: int, n_views: int,
                  H: int = 128, seed: int = 0) -> None:
    """Seeded SRN-layout split ``srn_cars/<split>``: poses on a sphere of
    radius 1.3 looking at the origin (the SRN-cars camera distance), images
    a shaded disk of a random albedo on white."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    focal = 131.25 * H / 128.0             # SRN cars: 131.25 at 128 px
    yy, xx = np.mgrid[0:H, 0:H].astype(np.float32)
    rr = np.sqrt((xx - H / 2) ** 2 + (yy - H / 2) ** 2) / (H * 0.3)
    for oi in range(n_objs):
        obj = os.path.join(root, "srn_cars", split, f"obj{oi:04d}")
        os.makedirs(os.path.join(obj, "pose"))
        os.makedirs(os.path.join(obj, "rgb"))
        with open(os.path.join(obj, "intrinsics.txt"), "w") as f:
            f.write(f"{focal} {H / 2} {H / 2} 0.\n0. 0. 0.\n1.\n{H} {H}\n")
        albedo = rng.uniform(0.1, 0.9, 3)
        for vi in range(n_views):
            az = 2 * math.pi * vi / n_views
            el = rng.uniform(0.2, 0.6)
            cam = 1.3 * np.array([math.cos(az) * math.cos(el),
                                  math.sin(az) * math.cos(el), math.sin(el)])
            fwd = -cam / np.linalg.norm(cam)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            up = np.cross(right, fwd)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, cam
            np.savetxt(os.path.join(obj, "pose", f"{vi:06d}.txt"),
                       (c2w @ flip).reshape(1, 16))
            shade = np.clip(1.0 - rr, 0.0, 1.0)[..., None]
            img = np.where(rr[..., None] < 1.0, albedo * (0.5 + 0.5 * shade),
                           1.0)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(obj, "rgb", f"{vi:06d}.png"))


def _metrics(run_dir: str):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(run_dir: str):
    return [(r["step"], r["loss/train"]) for r in _metrics(run_dir)
            if "loss/train" in r]


def _occ_events(run_dir: str):
    """(step, rebuild?, occupied share) of each occupancy grid refresh."""
    return [(r["step"], bool(r["occ/rebuild"]), r["occ/occupied"])
            for r in _metrics(run_dir) if "occ/rebuild" in r]


class LaunchCounts:
    """The launch counters of every kernel wrapper, zeroed on entry; and
    the plain versions wrapped so that a call on a CUDA tensor is counted
    (the main path must make none). The forward wrappers' counts of the
    planes stored by TMA (``bulk_planes``) are zeroed too and summed into
    ``MAIN_BULK`` on exit."""

    def __enter__(self):
        import torch

        from codenerf_tpu_torch.ops import (code_rows, composite, fused_mlp,
                                            fused_train)

        self._counters = (fused_train.train_fused.launches,
                          fused_mlp.sigma_fwd.launches,
                          fused_mlp.planes_fwd.launches,
                          fused_train.plane_bwd.launches,
                          composite.launches,
                          fused_train.pack_trunk_weights.launches,
                          code_rows.launches)
        self._points = (fused_train.train_fused.points,
                        fused_mlp.sigma_fwd.points,
                        fused_mlp.planes_fwd.points,
                        fused_train.plane_bwd.points, composite.points,
                        code_rows.points)
        self._bulk = (fused_train.train_fused.bulk_planes,
                      fused_mlp.sigma_fwd.bulk_planes,
                      fused_mlp.planes_fwd.bulk_planes,
                      fused_train.plane_bwd.bulk_planes)
        for c in self._counters + self._points + self._bulk:
            for k in c:
                c[k] = 0
        # The kernels' standalone wrappers, for the phase-2 checks alone:
        # the main paths must launch none of them.
        self._alone = {"input_chain (alone)": fused_mlp.input_chain,
                       "plane_head (alone)": fused_mlp.plane_head,
                       "sigma_head (alone)": fused_mlp.sigma_head,
                       "fold_ray_sums (alone)": fused_train.fold_ray_sums,
                       "weight_grads (alone)": fused_train.weight_grads}
        for fn in self._alone.values():
            fn.launches = 0
        self.plain_on_cuda = 0
        self._orig = [(mod, name, getattr(mod, name)) for mod, name in (
            (fused_mlp, "sigma_fwd_plain"), (fused_mlp, "planes_fwd_plain"),
            (fused_train, "train_fused_plain"),
            (fused_train, "plane_bwd_plain"),
            (fused_train, "weight_grads_plain"), (fused_train, "head_plain"),
            (fused_mlp, "input_chain_plain"), (fused_mlp, "plane_head_plain"),
            (fused_mlp, "sigma_head_plain"),
            (fused_train, "fold_ray_sums_plain"),
            (composite, "composite_fwd_plain"),
            (composite, "composite_bwd_plain"),
            (code_rows, "code_row_sums_plain"))]

        def watch(fn):
            def wrapped(*args, **kw):
                flat = list(args) + [x for a in args if isinstance(
                    a, (list, tuple)) for x in a]
                if any(torch.is_tensor(a) and a.is_cuda for a in flat):
                    self.plain_on_cuda += 1
                return fn(*args, **kw)
            return wrapped

        for mod, name, fn in self._orig:
            setattr(mod, name, watch(fn))
        # Every fused_step launch converts its rays' code cotangents: their
        # count prices the conversion's launches in the closing order.
        self.rays = 0
        launch = fused_train._launch_cuda

        def counted(cfg, S, R, *args, **kw):
            self.rays += R
            return launch(cfg, S, R, *args, **kw)

        self._orig.append((fused_train, "_launch_cuda", launch))
        fused_train._launch_cuda = counted
        return self

    def get(self) -> dict:
        counts = {k: v for c in self._counters for k, v in c.items()}
        counts.update((k, fn.launches) for k, fn in self._alone.items())
        return counts

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        for c in self._points:
            for k, v in c.items():
                MAIN_POINTS[k] = MAIN_POINTS.get(k, 0) + v
        for c in self._bulk:
            for k, v in c.items():
                MAIN_BULK[k] = MAIN_BULK.get(k, 0) + v
        MAIN_POINTS["ray_sum_fold"] = MAIN_POINTS.get("ray_sum_fold",
                                                     0) + self.rays
        return False


# The points (R * S) of every launch the main paths made, per mode, summed
# over phases 3-12 (each LaunchCounts window adds its own); for
# "ray_sum_fold" the rays of every fused_step launch.
MAIN_POINTS = {}
# The planes the forward of every launch the main paths made stored from
# trunk_fwd_kernel's tile by TMA, per mode, summed the same way.
MAIN_BULK = {}


def _config(work: str, name: str, out=None, data: str = "data",
            **extra) -> str:
    """``jsonfiles/<name>`` pointed at the seeded data (``<work>/<data>``),
    with ``extra``, written to ``<work>/<out or name>``."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jsonfiles", name)) as f:
        cfg = json.load(f)
    cfg["data"]["data_dir"] = os.path.join(work, data)
    cfg.update(extra)
    path = os.path.join(work, out or name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _expect(counts: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in counts.items() if v or k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def train_path(work: str, jsonfile: str, device: str, batch: int, H: int,
               iters_crop: int, iters_all: int, mid: int, per_step: dict,
               run: str, hier: bool, exact_resume: bool = False) -> dict:
    """The port's train CLI, then a second run resumed from a copy of the
    mid-run checkpoint. ``per_step``: the launches of each kernel mode one
    step makes. The coarse run must resume exactly; the hierarchical run
    must rebuild its occupancy grid on the resume (the density is not
    checkpointed). Returns the launch counts of both runs."""
    import numpy as np

    from codenerf_tpu_torch import train

    if not os.path.isdir(os.path.join(work, "data", "srn_cars",
                                      "cars_train")):
        write_dataset(os.path.join(work, "data"), "cars_train", 4, 4, H,
                      seed=1)
    exps = os.path.join(work, "exps")
    base = ["--jsonfile", jsonfile, "--exps_root", exps, "--batchsize",
            str(batch), "--iters_crop", str(iters_crop), "--check_iter", "0",
            "--log_every", "1", "--device", device]
    on_card = device != "cpu"       # the counters count CUDA launches only
    with LaunchCounts() as lc:
        t0 = time.perf_counter()
        train.main(base + ["--save_dir", run, "--iters_all", str(iters_all),
                           "--resume", "false"])
        wall = time.perf_counter() - t0
        first = lc.get()
        run_dir = os.path.join(exps, run)
        losses = _losses(run_dir)
        log(f"  train: launches {first} in {iters_all} steps, {wall:.2f} s "
            f"host clock incl. set-up; loss by step "
            f"{[(s_, round(v, 6)) for s_, v in losses]}")
        _expect(first, {k: v * iters_all * on_card
                        for k, v in per_step.items()}, "training run")
        if len(losses) != iters_all or not np.isfinite(
                [v for _, v in losses]).all():
            raise AssertionError("training losses missing or not finite")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
        mid_ck = f"step_{mid:08d}.pt"
        if mid_ck not in ckpts or f"step_{iters_all:08d}.pt" not in ckpts:
            raise AssertionError(f"checkpoints missing: {ckpts}")
        if hier:
            ev = _occ_events(run_dir)
            log(f"  occupancy grid (step, full rebuild, occupied share): "
                f"{ev}")

        resumed_run = f"{run}_resumed"
        os.makedirs(os.path.join(exps, resumed_run, "ckpt"))
        shutil.copy(os.path.join(run_dir, "ckpt", mid_ck),
                    os.path.join(exps, resumed_run, "ckpt", mid_ck))
        train.main(base + ["--save_dir", resumed_run, "--iters_all",
                           str(iters_all), "--resume", "true"])
        total = lc.get()
        if lc.plain_on_cuda:
            raise AssertionError(f"{lc.plain_on_cuda} plain-version calls "
                                 f"on CUDA tensors on the training path")
    resumed = {k: total[k] - first[k] for k in total}
    losses_r = _losses(os.path.join(exps, resumed_run))
    log(f"  resume: launches {resumed} in {iters_all - mid} steps; loss by "
        f"step {[(s_, round(v, 6)) for s_, v in losses_r]}")
    _expect(resumed, {k: v * (iters_all - mid) * on_card
                      for k, v in per_step.items()}, "resumed run")
    if not np.isfinite([v for _, v in losses_r]).all():
        raise AssertionError("resumed losses not finite")
    last, last_r = losses[-1], losses_r[-1]
    if exact_resume:
        # The same batches, depths and rebuilt grid, and every sum in a
        # fixed order: the same trajectory, bit for bit.
        mine = dict(losses)
        for step_, v in losses_r:
            if v != mine[step_]:
                raise AssertionError(f"resumed run at step {step_}: loss "
                                     f"{v}, uninterrupted {mine[step_]}")
        log(f"  resume: losses of steps {[s_ for s_, _ in losses_r]} the "
            f"uninterrupted run's, bit for bit")
    if hier:
        # A resume past the warm-up rebuilds the grid from the restored
        # model (JAX trainer.py:300-311), so the runs need not agree.
        ev = _occ_events(os.path.join(exps, resumed_run))
        log(f"  resumed occupancy grid (step, full rebuild, occupied "
            f"share): {ev}; final loss {last_r[1]:.6f} (uninterrupted "
            f"{last[1]:.6f})")
        if not ev or ev[0][:2] != (mid, True):
            raise AssertionError("the resumed run did not rebuild its "
                                 "occupancy grid")
    # The uninterrupted and the resumed run see the same batches and
    # depths, and every sum runs in a fixed order: the same bits.
    elif last_r != last:
        raise AssertionError(f"resumed run ends at {last_r}, the "
                             f"uninterrupted one at {last}")
    if on_card:
        profile_training(jsonfile, run_dir, device, batch, run,
                         per_step.get("pack", 0))
    return total


def profile_training(jsonfile: str, run_dir: str, device: str,
                     batch: int, what: str, packs: int,
                     steps: int = 10) -> None:
    """The training step's profile, resumed from the run's checkpoint
    (with its occupancy grid rebuilt, as a resumed run does); ``packs``
    pack_kernel launches a step (one per network)."""
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.training.trainer import Trainer

    hp = load_hparams(jsonfile)
    tr = Trainer("profile", hp, batch_size=batch,
                 exps_root=os.path.dirname(run_dir), check_iter=0,
                 device=device)
    tr.ckpt_dir = os.path.join(run_dir, "ckpt")
    tr.resume()
    if hp.train_occupancy is not None:
        tr._rebuild_occupancy()
    out = tr.profile_steps(steps, trace_dir=os.path.join(
        os.path.dirname(run_dir), f"profile_{what}"))
    log_step_profile(f"{what} train", out["untraced_ms"], out["wall_ms"],
                     out["profile"], steps, packs_per_step=packs)


def _kernel_launches(n_rays: int, chunk: int) -> int:
    """The four-plane forward's (and the composite's) launches in one
    ``render_image`` of ``n_rays`` rays on the forward kernels' route: one
    a group of whole chunks up to ``renderer.KERNEL_RAYS`` rays."""
    from codenerf_tpu_torch.renderer import KERNEL_RAYS, chunk_plan

    chunk, n_chunks, _ = chunk_plan(n_rays, chunk)
    return -(-n_chunks // max(1, KERNEL_RAYS // chunk))


def _eval_kernels(hp) -> tuple:
    """The forward kernels' wrappers a render of ``hp`` launches on the
    kernels' route, each once a launch group: the sigma-only forward
    first where the render is hierarchical."""
    return (("sigma",) if hp.render.n_importance > 0 else ()) + (
        "planes", "composite")


def _route_chunks(before: dict, n: int, kernels: bool, what: str) -> int:
    """Check that the renders since ``before`` (a copy of
    ``renderer.render_image.chunks``) rendered ``n`` chunks, all on the
    forward kernels' route where ``kernels``, else all on the plain
    module's; returns the chunks on the kernels' route."""
    from codenerf_tpu_torch.renderer import render_image

    got = {k: v - before[k] for k, v in render_image.chunks.items()}
    want = {"kernels": n if kernels else 0, "plain": 0 if kernels else n}
    if got != want:
        raise AssertionError(f"{what}: chunks by route {got}, expected "
                             f"{want}")
    return got["kernels"]


def optimize_path(work: str, jsonfile: str, run: str, device: str, H: int,
                  num_opts: int, per_chunk: dict, extra=(),
                  n_objs: int = 2, n_views: int = 4, data: str = "data",
                  what: str = "optimize", chunk: int = 4096,
                  nets: int = 1, eval_kernels: bool = False) -> dict:
    """The port's optimize CLI on the training run's ``ckpt/``, on the
    seeded ``<work>/<data>/srn_cars/cars_test`` set of H×H views (written
    if missing). ``per_chunk``: the launches of each kernel mode one chunk
    of one step makes; the frozen weights of each of the ``nets``
    networks are packed once in the whole run. ``eval_kernels``: the eval
    renders take the forward kernels' route (``renderer.kernel_route``),
    one four-plane forward and one composite a launch group of each eval
    view (``_kernel_launches``), on the weights the fitting packed, and
    for a hierarchical config (``N_importance`` > 0) one sigma-only
    forward besides. Returns the CLI's output with the launch counts
    under ``"counts"``."""
    import numpy as np
    import torch

    from codenerf_tpu_torch import optimize
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.renderer import chunk_plan, render_image

    hp = load_hparams(jsonfile)
    data_dir = os.path.join(work, data)
    if not os.path.isdir(os.path.join(data_dir, "srn_cars", "cars_test")):
        write_dataset(data_dir, "cars_test", n_objs, n_views, H)
    exps = os.path.join(work, "exps")
    if os.path.exists(os.path.join(exps, run, "models.pth")):
        raise AssertionError("the run must be read from its ckpt/")
    kernel_chunks = render_image.chunks["kernels"]
    with LaunchCounts() as lc:
        out = optimize.main([
            "--jsonfile", jsonfile, "--exps_root", exps, "--saved_dir", run,
            "--num_opts", str(num_opts), "--tgt_instances", "0", "--device",
            device, "--batchsize", str(chunk), *extra])
        counts = out["counts"] = lc.get()
        if lc.plain_on_cuda:
            raise AssertionError(f"{lc.plain_on_cuda} plain-version calls "
                                 f"on CUDA tensors on the optimize path")
    kernel_chunks = render_image.chunks["kernels"] - kernel_chunks
    _, chunks, _ = chunk_plan(H * H, chunk)
    n = num_opts * chunks * n_objs
    views = out["timing"]["eval_views"] if eval_kernels and device != "cpu" \
        else 0
    if kernel_chunks != views * chunks:
        raise AssertionError(f"optimize path: {kernel_chunks} eval chunks "
                             f"through the forward kernels, expected "
                             f"{views * chunks}")
    n_eval = views * _kernel_launches(H * H, chunk)
    want = {k: v * n for k, v in per_chunk.items()}
    for k in _eval_kernels(hp):
        want[k] = want.get(k, 0) + n_eval
    log(f"  optimize: launches {counts} (expected {num_opts} steps x "
        f"{chunks} chunks x {n_objs} objects x per chunk {per_chunk}, "
        f"{n_eval} eval launches through the forward kernels, and pack "
        f"{nets})")
    _expect(counts, {k: v * (device != "cpu") for k, v in dict(
        {k: v for k, v in want.items() if v}, pack=nets).items()},
            "optimize path")
    with open(os.path.join(out["save_dir"], "results.json")) as f:
        res = json.load(f)
    vals = [res["mean_psnr"], res["mean_ssim"]]
    for row in res["per_object"]:
        vals += [row["psnr"], row["ssim"]]
    hist = [v for h in out["psnr_history"].values() for v in h]
    if not (np.isfinite(vals).all() and np.isfinite(hist).all()):
        raise AssertionError(f"non-finite results: {res} {hist}")
    if len(res["per_object"]) != n_objs or len(hist) != n_objs * num_opts:
        raise AssertionError("results.json / history have the wrong shape")
    codes = torch.load(os.path.join(out["save_dir"], "codes.pth"),
                       weights_only=False)
    if tuple(codes["optimized_shapecodes"].shape) != (n_objs,
                                                      hp.net.latent_dim):
        raise AssertionError("codes.pth has the wrong shape")
    t = out["timing"]
    log(f"  optimize: psnr_history {[round(v, 3) for v in hist]}")
    log(f"  optimize: mean eval psnr {res['mean_psnr']:.4f} ssim "
        f"{res['mean_ssim']:.4f}")
    log(f"  optimize: {1e3 * t['opt_s'] / t['opt_steps']:.3f} ms per opt "
        f"step ({chunks} chunk(s) of {chunk_plan(H * H, chunk)[0]} rays, "
        f"{H * H} of them real; host clock "
        f"incl. first-object warm-up), "
        f"{1e3 * t['eval_s'] / t['eval_views']:.3f} ms per eval view "
        f"({H}x{H})")
    if device != "cpu":
        profile_optimize(hp, os.path.join(exps, run), data_dir, device,
                         what)
    return out


def profile_optimize(hp, run_dir: str, data_dir: str, device: str,
                     what: str, steps: int = 10) -> None:
    """Where an optimization step's time goes: ``steps`` steps of the first
    object untraced, then ``steps`` more under torch.profiler, after one
    warm-up step. With ``train_occupancy`` the category grid bounds the
    depths, as with ``--opt_occ true``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from codenerf_tpu_torch.config import resolve_dtype
    from codenerf_tpu_torch.core.occupancy import rebuild_category_grid
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer
    from codenerf_tpu_torch.utils.checkpoint import load_run

    model, fine, sc, tc = load_run(run_dir, hp, device)
    occ = None
    if hp.train_occupancy is not None:
        oc = hp.train_occupancy
        occ = rebuild_category_grid(
            model, sc.to(device), tc.to(device), oc,
            oc.radius or hp.render.bound_sphere_radius,
            compute_dtype=resolve_dtype(hp.compute_dtype))
    opt = CodeOptimizer(model, hp, mean_code(sc), mean_code(tc),
                        device=device, occ_grid=occ, fine_model=fine)
    ds = SRNDataset(splits="cars_test", data_dir=data_dir, max_objects=1)
    gen = torch.Generator(device=device).manual_seed(0)
    args = (ds.images[0], ds.poses[0], float(ds.focals[0]), [0], gen)
    opt.optimize_object(*args, num_opts=1, progress_images=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize_object(*args, num_opts=steps, progress_images=True)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.optimize_object(*args, num_opts=steps, progress_images=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    log_step_profile(what, untraced_ms, wall_ms, prof, steps)


def pose_path(work: str, jsonfile: str, run: str, device: str,
              num_opts: int, rays: int, per_step: dict, what: str,
              n_objs: int = 2, nets: int = 1, H: int = 128,
              strip_kernels: bool = False) -> dict:
    """The port's pose CLI on the training run's ``ckpt/`` and the seeded
    ``cars_test`` set of H×H views that ``optimize_path`` wrote.
    ``per_step``: the launches of each kernel mode one pose step makes;
    the frozen weights of each of the ``nets`` networks are packed once in
    the whole run. Each object's strip renders the initial and the refined
    pose: 2 x ``n_objs`` renders of ``chunk_plan`` chunks, all on the
    forward kernels' route (``renderer.kernel_route``; one ``planes`` and
    one ``composite`` a launch, and one ``sigma`` where hierarchical,
    ``_kernel_launches`` a render) where ``strip_kernels`` and on the
    card, else all on the plain module's."""
    import numpy as np

    from codenerf_tpu_torch import pose_opt
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.renderer import chunk_plan, render_image

    exps = os.path.join(work, "exps")
    chunks0 = dict(render_image.chunks)
    with LaunchCounts() as lc:
        out = pose_opt.main([
            "--jsonfile", jsonfile, "--exps_root", exps, "--saved_dir", run,
            "--num_opts", str(num_opts), "--rays_per_step", str(rays),
            "--device", device])
        counts = lc.get()
        if lc.plain_on_cuda:
            raise AssertionError(f"{lc.plain_on_cuda} plain-version calls "
                                 f"on CUDA tensors on the pose path")
    strip_chunk = min(4096, H * H)
    n_strip = 2 * n_objs * chunk_plan(H * H, strip_chunk)[1]
    launches = 0
    if _route_chunks(chunks0, n_strip, strip_kernels and device != "cpu",
                     "pose path strips"):
        launches = 2 * n_objs * _kernel_launches(H * H, strip_chunk)
    n = num_opts * n_objs
    want = {k: v * n for k, v in per_step.items()}
    if launches:
        for k in _eval_kernels(load_hparams(jsonfile)):
            want[k] = want.get(k, 0) + launches
    log(f"  pose_opt: launches {counts} (expected {num_opts} steps x "
        f"{n_objs} objects x per step {per_step}, {launches} strip "
        f"launches through the forward kernels, and pack {nets})")
    _expect(counts, {k: v * (device != "cpu") for k, v in dict(
        want, pack=nets).items()}, "pose path")
    with open(os.path.join(out["save_dir"], "results.json")) as f:
        res = json.load(f)
    rows = res["per_object"]
    vals = [v for r in rows for k, v in r.items() if k != "id"]
    if len(rows) != n_objs or not np.isfinite(vals).all():
        raise AssertionError(f"results.json not finite or short: {res}")
    t = out["timing"]
    log(f"  pose_opt: per object (rot deg, trans before -> after; psnr "
        f"first -> last): " + "; ".join(
            f"{r['rot_err_deg_before']:.3f} -> {r['rot_err_deg_after']:.3f}, "
            f"{r['trans_err_before']:.4f} -> {r['trans_err_after']:.4f}; "
            f"{r['psnr_first']:.3f} -> {r['psnr_last']:.3f}" for r in rows))
    log(f"  pose_opt: {1e3 * t['opt_s'] / t['opt_steps']:.3f} ms per pose "
        f"step ({rays} rays, host clock incl. first-object warm-up)")
    if device != "cpu":
        profile_pose(load_hparams(jsonfile), os.path.join(exps, run),
                     os.path.join(work, "data"), device, rays, what)
    return counts


def profile_pose(hp, run_dir: str, data_dir: str, device: str, rays: int,
                 what: str, steps: int = 10) -> None:
    """Where a pose step's time goes: ``steps`` steps of the first object
    untraced, then ``steps`` more under torch.profiler, after one warm-up
    step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.pose_opt import \
        optimize_pose_and_codes
    from codenerf_tpu_torch.utils.checkpoint import load_run

    model, fine, sc, tc = load_run(run_dir, hp, device)
    ds = SRNDataset(splits="cars_test", data_dir=data_dir, max_objects=1)
    image = torch.from_numpy(ds.images[0, 1].astype(np.float32) / 255.0).to(
        device)
    pose = torch.from_numpy(np.asarray(ds.poses[0, 1], np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def run(n):
        optimize_pose_and_codes(model, hp, image, pose, float(ds.focals[0]),
                                mean_code(sc).to(device),
                                mean_code(tc).to(device), gen, num_opts=n,
                                rays_per_step=rays, pose_only_steps=n // 2,
                                fine_model=fine)
        torch.cuda.synchronize()

    run(1)
    t0 = time.perf_counter()
    run(steps)
    untraced_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    log_step_profile(what, untraced_ms, wall_ms, prof, steps)
    # The step is short enough for the host to bound it: its largest
    # operators by host time (self CPU time, traced).
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    log(f"  {what} step, host ms per step by operator (traced; calls per "
        f"step): " + ", ".join(
            f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / steps:.3f} "
            f"({e.count // steps})" for e in ops[:12])
        + "; aten::_to_copy calls per step: " + str(sum(
            e.count for e in ops if e.key == "aten::_to_copy") / steps))


def _peak(device: str) -> str:
    import torch

    if device == "cpu":
        return "not measured (CPU)"
    return f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB"


def _reset_peak(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()


def main_path(work: str, device: str = "cuda", batch: int = R_TRAIN,
              H: int = 128, num_opts: int = 5) -> dict:
    """Phases 3 and 4 at ``srncar_fused.json`` widths (check_points cut to
    the mid-run step). ``device="cpu"`` with a small ``batch`` and ``H``
    rehearses them through the plain versions (the launch counts stay 0
    there: they count CUDA launches only)."""
    jsonfile = _config(work, "srncar_fused.json", check_points=5)
    t0 = time.perf_counter()
    _reset_peak(device)
    train = train_path(work, jsonfile, device, batch, H, iters_crop=5,
                       iters_all=10, mid=5,
                       per_step={"train": 1, "pack": 1, "code_rows": 2},
                       run="smoke", hier=False)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    t0 = time.perf_counter()
    _reset_peak(device)
    codes = optimize_path(work, jsonfile, "smoke", device, H, num_opts,
                          per_chunk={"codes": 1},
                          eval_kernels=True)["counts"]
    log(f"phase 4: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    return {"train": train["train"], "codes": codes["codes"],
            "pack": train["pack"] + codes["pack"],
            "code_rows": train["code_rows"],
            "planes": codes.get("planes", 0),
            "composite": codes.get("composite", 0)}


def _hier_occ_config(work: str, grid_size=None, out=None, **extra) -> str:
    """``srncar_hier_occ.json`` with the smoke's cuts: the occupancy
    warm-up at 4 steps and a refresh every 2 (so that the rebuild and two
    refreshes run), ``check_points`` at mid-run; ``grid_size`` replaces
    the grid's G (the CPU rehearsal's cut)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jsonfiles", "srncar_hier_occ.json")) as f:
        occ_cfg = json.load(f)["train_occupancy"]
    occ_cfg.update(warmup=4, update_every=2)
    if grid_size:
        occ_cfg["grid_size"] = grid_size
    return _config(work, "srncar_hier_occ.json", out=out, check_points=4,
                   train_occupancy=occ_cfg, **extra)


def hier_path(work: str, device: str = "cuda", batch: int = R_TRAIN,
              H: int = 128, num_opts: int = 5, grid_size=None) -> dict:
    """Phases 5 and 6 at ``srncar_hier_occ.json`` widths, with its cuts:
    the occupancy warm-up at 4 steps and a refresh every 2 (so that the
    rebuild and two refreshes run), ``check_points`` at mid-run, 8 steps.
    ``grid_size`` replaces the grid's G (the CPU rehearsal's cut)."""
    jsonfile = _hier_occ_config(work, grid_size)
    t0 = time.perf_counter()
    _reset_peak(device)
    train = train_path(work, jsonfile, device, batch, H, iters_crop=4,
                       iters_all=8, mid=4,
                       per_step={"sigma": 1, "dual_train": 1, "pack": 1,
                                 "code_rows": 2},
                       run="hier", hier=True)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    t0 = time.perf_counter()
    _reset_peak(device)
    codes = optimize_path(work, jsonfile, "hier", device, H, num_opts,
                          per_chunk={"sigma": 1, "dual_codes": 1},
                          extra=("--opt_occ", "true"),
                          what="hier optimize", eval_kernels=True)["counts"]
    log(f"phase 6: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    return {"sigma": train["sigma"] + codes["sigma"],
            "dual_train": train["dual_train"],
            "dual_codes": codes["dual_codes"],
            "planes": codes["planes"], "composite": codes["composite"],
            "pack": train["pack"] + codes["pack"],
            "code_rows": train["code_rows"]}


def pose_paths(work: str, device: str = "cuda", num_opts: int = 20,
               rays: int = R_POSE, H: int = 128) -> dict:
    """Phases 7 and 8: the pose CLI on the coarse run of phase 3 and the
    hierarchical run of phase 5, with the configs and the ``cars_test``
    set of H×H views that phases 3-6 wrote to ``work``."""
    out = {}
    for phase, name, run, per_step, what in (
            (7, "srncar_fused.json", "smoke", {"pose": 1}, "pose"),
            (8, "srncar_hier_occ.json", "hier",
             {"pose_weights": 1, "pose": 1}, "hier pose")):
        t0 = time.perf_counter()
        _reset_peak(device)
        counts = pose_path(work, os.path.join(work, name), run, device,
                           num_opts, rays, per_step, what, H=H,
                           strip_kernels=True)
        for k in (*per_step, "pack", "sigma", "planes", "composite"):
            out[k] = out.get(k, 0) + counts[k]
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s; peak device "
            f"memory {_peak(device)}")
    return out


def fine_paths(work: str, device: str = "cuda", batch: int = R_TRAIN,
               H: int = 128, num_opts: int = 5, grid_size=None,
               pose_steps: int = 20, rays: int = R_POSE) -> dict:
    """Phases 9-11, the separate fine network: ``srncar_hier_occ.json``
    with ``hierarchical_share_weights: false`` and phase 5's cuts. Phase
    9 trains 8 steps and resumes 4 from step 4 (the grid rebuilt, the
    same trajectory), each step one four-plane forward and one training
    plane-op backward per network; phase 10 runs ``optimize --opt_occ
    true`` on that run (one forward and one frozen backward per network
    and chunk); phase 11 the pose CLI (the same, in the pose mode, per
    step). It needs the ``cars_test`` set of phase 4."""
    jsonfile = _hier_occ_config(work, grid_size,
                                out="srncar_hier_occ_fine.json",
                                hierarchical_share_weights=False)
    out = {}
    t0 = time.perf_counter()
    _reset_peak(device)
    train = train_path(work, jsonfile, device, batch, H, iters_crop=4,
                       iters_all=8, mid=4,
                       per_step={"planes": 2, "plane_train": 2, "pack": 2,
                                 "code_rows": 2},
                       run="fine", hier=True, exact_resume=True)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    t0 = time.perf_counter()
    _reset_peak(device)
    codes = optimize_path(work, jsonfile, "fine", device, H, num_opts,
                          per_chunk={"planes": 2, "plane_codes": 2},
                          extra=("--opt_occ", "true"),
                          what="fine optimize", nets=2,
                          eval_kernels=True)["counts"]
    log(f"phase 10: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    t0 = time.perf_counter()
    _reset_peak(device)
    pose = pose_path(work, jsonfile, "fine", device, pose_steps, rays,
                     {"planes": 2, "plane_pose": 2}, "fine pose", nets=2,
                     H=H, strip_kernels=True)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    for counts in (train, codes, pose):
        _add(out, counts)
    return out


def padded_path(work: str, device: str = "cuda", H: int = 127,
                num_opts: int = 5, chunk: int = 4096) -> dict:
    """Phase 12: the optimize CLI on phase 3's coarse run against a seeded
    ``cars_test`` set of H×H views whose rays do not split into equal
    chunks (127×127: 16,129 rays, padded to 4 × 4096): each chunk is the
    four-plane forward, the standalone composite and its backward, and
    the frozen plane-op backward. The first step's reported PSNR must be
    that of the 16,129 real rays: it is recomputed here from the same
    draws with the plain versions on the unpadded rays."""
    import numpy as np
    import torch

    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.ops import composite, fused_mlp, fused_train
    from codenerf_tpu_torch.optimization.codes_opt import (
        _flat_target_rays, codes_route)
    from codenerf_tpu_torch.renderer import chunk_plan, coarse_zvals, pad_rays
    from codenerf_tpu_torch.utils.checkpoint import load_run

    jsonfile = _config(work, "srncar_fused.json", out="srncar_fused_pad.json",
                       data="data_pad")
    hp = load_hparams(jsonfile)
    n = H * H
    c, n_chunks, n_padded = chunk_plan(n, chunk)
    route = codes_route(hp, n, chunk)
    log(f"  {H}x{H} views: {n} rays in {n_chunks} chunks of {c} "
        f"({n_padded - n} pad rays); route {route}")
    if route != "plane_op_composite":
        raise AssertionError(f"a padded view takes route {route}")
    t0 = time.perf_counter()
    _reset_peak(device)
    out = optimize_path(work, jsonfile, "smoke", device, H, num_opts,
                        per_chunk={"planes": 1, "composite": 1,
                                   "composite_bwd": 1, "plane_codes": 1},
                        data="data_pad", what="padded optimize", chunk=chunk,
                        eval_kernels=True)
    # The CLI's first object, first step: the same generator and draws.
    model, _, sc, tc = load_run(os.path.join(work, "exps", "smoke"), hp,
                                device)
    ds = SRNDataset(splits="cars_test", data_dir=os.path.join(work,
                                                              "data_pad"),
                    max_objects=1)
    master = torch.Generator().manual_seed(hp.seed)
    s_opt = int(torch.randint(0, 2 ** 62, (2,), generator=master)[0])
    gen = torch.Generator(device=device).manual_seed(s_opt)
    ro, vd, gt = _flat_target_rays(ds.images[0], ds.poses[0],
                                   float(ds.focals[0]), [0], H, H, device)
    ro_p, vd_p = pad_rays(ro, n_padded), pad_rays(vd, n_padded)
    z = torch.cat([coarse_zvals(hp.render, ro_p[i * c:(i + 1) * c],
                                vd_p[i * c:(i + 1) * c], gen)
                   for i in range(n_chunks)])[:n]
    with torch.no_grad():
        ops = fused_mlp.prep_ray_operands(model, hp.net, ro, vd, z,
                                          mean_code(sc).to(device),
                                          mean_code(tc).to(device))
        planes = fused_mlp.planes_fwd_plain(
            hp.net, z.shape[1], n, *ops,
            fused_train.flatten_params(model, hp.net))
        out8 = composite.composite_fwd_plain(*planes, z, hp.render.white_bg)
        mse = float(torch.mean((out8[:, :3] - gt) ** 2))
        del ops, planes
    first = next(iter(out["psnr_history"].values()))[0]
    want = -10.0 * math.log10(mse)
    ok = abs(first - want) <= 2e-3
    log(f"  padded optimize: first step's PSNR {first:.5f} dB, the plain "
        f"versions on the {n} unpadded rays {want:.5f} dB"
        f"{'' if ok else '  <-- FAILS'}")
    if not ok or not np.isfinite(first):
        raise AssertionError("the padded chunks' PSNR is not the real "
                             "rays'")
    log(f"phase 12: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak(device)}")
    return out["counts"]


# Phase 14's cuts of the standard quality protocol (docs/QUALITY_SYNTHETIC.md
# :298-308: 16 + 4 objects, 24 views at 64x64, 10K steps of 8192 rays,
# the fused single pass at 96 samples): one seed and a tenth of the steps.
SERVE_REQUESTS = 20


def _u8(img):
    """A render clipped ×255 to uint8, as the server and the orbit CLI
    write it."""
    import numpy as np

    return np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)


def _http(url: str, body=None):
    """(status, content type, bytes) of a GET (``body`` None) or a POST."""
    import urllib.error
    import urllib.request

    data = body if body is None or isinstance(body, bytes) else \
        json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _served_nets(dev, shared: bool, seed: int = 21):
    """A coarse network (and, unless ``shared``, a fine one) and one
    object's codes drawn as portbench's served cells draw them: every
    layer's uniform range widened by sqrt(6), ``rgb_out`` centred on 0.5
    with a spread of 0.25, and the density layer times 16 (a sharp
    model; ``car_nerf_hier.serve`` scales it by 64); codes
    N(0, 2/latent_dim). Weights of order
    one, as a trained model's, where a lightly trained run's are near the
    initialisation."""
    import torch

    from codenerf_tpu_torch.config import NetConfig
    from codenerf_tpu_torch.models.codenerf import CodeNeRF

    cfg = NetConfig()
    g = torch.Generator().manual_seed(seed)
    nets = []
    for _ in range(1 if shared else 2):
        model = CodeNeRF(cfg, generator=g).requires_grad_(False)
        for name, lin in model.named_children():
            scale = 16.0 if name == "sigma" else 1.0
            if name == "rgb_out":
                lin.weight.mul_(0.25 * math.sqrt(3.0))
                lin.bias.mul_(0.025 * math.sqrt(lin.weight.shape[1]))
                lin.bias.add_(0.5)
            else:
                lin.weight.mul_(math.sqrt(6.0) * scale)
                lin.bias.mul_(math.sqrt(6.0) * scale)
        nets.append(model.to(dev))
    codes = torch.randn(2, cfg.latent_dim, generator=g) \
        / math.sqrt(cfg.latent_dim / 2.0)
    return (nets[0], None if shared else nets[1], codes[0].to(dev),
            codes[1].to(dev))


def service_path(work: str, device: str = "cuda", H: int = 128,
                 requests: int = SERVE_REQUESTS, grid_size: int = 64) -> dict:
    """Phase 15: the user-facing tools on phase 3's coarse run and phase
    5's occupancy run (both at flagship widths), each through its entry
    point. ``codenerf_tpu_torch.serving.RenderServer`` on 127.0.0.1:0 in a
    background thread serves H×H renders by object, by raw codes with an
    orbit camera and (on the hierarchical run, ``use_occupancy``) with a
    per-object occupancy grid of ``grid_size``; each served PNG must equal
    ``renderer.render_image`` of the same camera, codes and grid clipped
    ×255, uint8 for uint8. The three error paths (an object outside the
    table and a body that is not JSON: 400; another path: 404). Then
    ``requests`` more renders by object and ``/stats``' p50 and p95. The
    export (``export_reference_checkpoint``) of the coarse run read back
    by ``load_reference_checkpoint``: every weight and both tables
    bit-equal to the checkpoint's; the separate-fine run of phase 9
    refused. ``edit`` on objects 0 and 1 with ``--grid 3``: the swap
    matrix's diagonal equal to direct renders of those codes from the
    edit's camera. ``render_orbit`` with 4 frames and
    ``estimate_bound_radius`` (a finite positive radius). The coarse
    run's renders take the forward kernels' route
    (``renderer.kernel_route``): one four-plane forward and one composite
    a launch (``_kernel_launches`` a view), on weights packed once for
    each model (the server's,
    ``edit``'s and ``render_orbit``'s); one served H×H view is held
    against the plain module at float32 over the same rays, no further
    from it than the bf16 plain module (mean within 1.1 times, worst
    within a level). The hierarchical run's renders take the kernels'
    hierarchical route (one sigma-only forward before them; its model
    packed once), and so does phase 9's separate fine network rendered
    at NeRF's 64 + 128 samples (both networks packed once); their gaps
    to float32 are printed. A 64 + 128 view of networks drawn as the
    served cells draw them, the density sharpened (``_served_nets``),
    with separate and with shared fine weights, is held to float32
    likewise. (On the
    runs' near-initial weights the kernel route's mean gap reads about
    1.4 times the bf16 module's, both under a sixtieth of a level; the
    coarse route's reads so too on the CPU at such weights.) No other
    port kernel may launch.
    Returns the served latencies."""
    import numpy as np
    import torch
    from PIL import Image

    from codenerf_tpu_torch import (edit, estimate_bound_radius,
                                    export_reference_checkpoint,
                                    render_orbit)
    from codenerf_tpu_torch.config import load_hparams, resolve_dtype
    from codenerf_tpu_torch.core.occupancy import build_occupancy_grid
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.core.rays import camera_rays
    from codenerf_tpu_torch.render_orbit import orbit_pose
    from codenerf_tpu_torch.renderer import (chunk_plan, kernel_route,
                                             render_image, render_rays)
    from codenerf_tpu_torch.serving import RenderServer
    from codenerf_tpu_torch.utils.checkpoint import (load_reference_checkpoint,
                                                     load_run,
                                                     read_checkpoint)

    exps = os.path.join(work, "exps")
    coarse_json = os.path.join(work, "srncar_fused.json")
    hier_json = os.path.join(work, "srncar_hier_occ.json")
    dev = torch.device(device)
    checks = []

    def direct(net, c2w, sc, tc, h, w, focal, occ=None, chunk=4096):
        """``render_image`` with ``net``'s (model, fine model, hp)."""
        model, fine, hp_ = net
        return render_image(
            model, hp_.render, h, w, focal,
            torch.from_numpy(np.asarray(c2w, np.float32)).to(dev),
            sc.to(dev), tc.to(dev), None, chunk=chunk,
            compute_dtype=resolve_dtype(hp_.compute_dtype), occ_grid=occ,
            fine_model=fine)

    def served(srv, req, want, what):
        status, ctype, data = _http(f"http://{srv.host}:{srv.port}/render",
                                    req)
        ok = status == 200 and ctype == "image/png"
        if ok:
            got = np.asarray(Image.open(io.BytesIO(data)))
            ok = got.shape == want.shape and np.array_equal(got, want)
        log(f"  served {what} ({req.get('H')}x{req.get('W')}): status "
            f"{status}, {'equal to the direct render' if ok else 'DIFFERS'}"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append((f"served {what}", ok))

    def exactness(net, c2w, sc, tc, h, focal, what="served", held=True):
        """A view's render on the forward kernels' route against
        ``render_rays`` on the plain module(s) at float32 over the same
        rays and chunks, beside the bf16 plain module's gap: the kernel
        route's mean gap within 1.1 times the bf16 module's and its worst
        within a level (1/255) of the bf16 module's worst. A
        hierarchical view's fine depths follow each route's own coarse
        weights. ``held`` False prints the gaps and holds only that the
        route was taken."""
        model, fine, hp_ = net
        bf16, f32 = torch.bfloat16, torch.float32
        chunk = chunk_plan(h * h, 4096)[0]
        route = kernel_route(model, hp_.render, chunk,
                             resolve_dtype(hp_.compute_dtype), dev, fine)
        img = direct(net, c2w, sc, tc, h, h, focal).reshape(-1, 3)
        ro, vd = camera_rays(h, h, focal, torch.from_numpy(
            np.asarray(c2w, np.float32)).to(dev), device=dev)
        plain = {dt: torch.cat([render_rays(
            model, hp_.render, ro[i:i + chunk], vd[i:i + chunk], sc.to(dev),
            tc.to(dev), None, compute_dtype=dt, fine_model=fine).final.rgb
            for i in range(0, h * h, chunk)]) for dt in (bf16, f32)}
        k = (img - plain[f32]).abs()
        p = (plain[bf16] - plain[f32]).abs()
        ok = route and (not held or (
            float(k.mean()) <= 1.1 * float(p.mean())
            and float(k.max()) <= float(p.max()) + 1.0 / 255.0))
        log(f"  {what} {h}x{h} view against the plain module at float32: "
            f"kernel route {'taken' if route else 'NOT TAKEN'}, worst "
            f"{float(k.max()):.5f} mean {float(k.mean()):.6f}; the bf16 "
            f"plain module worst {float(p.max()):.5f} mean "
            f"{float(p.mean()):.6f}{'' if held else ' (not held)'}"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append((f"the kernel route against float32 ({what})", ok))

    kernel_chunks = render_image.chunks["kernels"]
    with LaunchCounts() as lc:
        hp = load_hparams(coarse_json)
        srv = RenderServer.from_checkpoint(os.path.join(exps, "smoke"), hp,
                                           device=device)
        net = (srv.model, srv.fine_model, hp)
        srv.start_background()
        try:
            base = f"http://{srv.host}:{srv.port}"
            focal = 1.1 * H
            served(srv, {"obj": 1, "H": H, "W": H, "azimuth": 0.9},
                   _u8(direct(net, orbit_pose(0.9, 0.3, 1.3),
                              srv.shape_codes[1], srv.texture_codes[1], H,
                              H, focal)), "by object")
            exactness(net, orbit_pose(0.9, 0.3, 1.3), srv.shape_codes[1],
                      srv.texture_codes[1], H, focal)
            sc = 0.5 * (srv.shape_codes[0] + srv.shape_codes[2])
            tc = 0.5 * (srv.texture_codes[0] + srv.texture_codes[2])
            served(srv, {"shape_code": sc.cpu().tolist(),
                         "texture_code": tc.cpu().tolist(), "H": H, "W": H,
                         "azimuth": 2.2, "elevation": 0.4, "radius": 1.4},
                   _u8(direct(net, orbit_pose(2.2, 0.4, 1.4), sc, tc, H, H,
                              focal)), "by raw codes, orbit camera")
            for what, path, body, want in (
                    ("an object outside the table", "/render",
                     {"obj": srv.n_objects}, 400),
                    ("a body that is not JSON", "/render", b"{obj: 0", 400),
                    ("another path", "/nope", {"obj": 0}, 404)):
                status = _http(base + path, body)[0]
                log(f"  {what}: status {status} (expected {want})")
                checks.append((what, status == want))
            for i in range(requests):
                status = _http(base + "/render", {
                    "obj": i % srv.n_objects, "H": H, "W": H,
                    "azimuth": 0.3 * i})[0]
                checks.append((f"request {i}", status == 200))
            stats = json.loads(_http(base + "/stats")[2])
            health = json.loads(_http(base + "/healthz")[2])
        finally:
            srv.shutdown()
        lat = stats["latency_ms"]
        log(f"  /healthz {health}; /stats: {stats['requests']} renders, "
            f"sizes {stats['compiled_sizes']}")
        log(f"phase 15: served {H}x{H} renders, p50 {lat['p50']:.3f} ms, "
            f"p95 {lat['p95']:.3f} ms, max {lat['max']:.3f} ms (the lock's "
            f"render time, PNG encoding not included; {requests + 2} "
            f"renders) on {card_line() if device != 'cpu' else 'the CPU'}")

        hier_chunks = render_image.chunks["kernels"]
        hhp = load_hparams(hier_json)
        hsrv = RenderServer.from_checkpoint(os.path.join(exps, "hier"), hhp,
                                            device=device, use_occupancy=True,
                                            occ_grid_size=grid_size)
        hnet = (hsrv.model, hsrv.fine_model, hhp)
        hsrv.start_background()
        try:
            req = {"obj": 0, "H": H, "W": H, "azimuth": 1.3}
            grid = build_occupancy_grid(
                hsrv.model, hsrv.shape_codes[0], hsrv.texture_codes[0],
                G=grid_size, radius=float(hhp.render.bound_sphere_radius),
                compute_dtype=resolve_dtype(hhp.compute_dtype))
            served(hsrv, req, _u8(direct(hnet, orbit_pose(1.3, 0.3, 1.3),
                                         hsrv.shape_codes[0],
                                         hsrv.texture_codes[0], H, H,
                                         1.1 * H, occ=grid)),
                   "with occupancy (hierarchical run)")
            served(hsrv, dict(req, azimuth=2.0), _u8(direct(
                hnet, orbit_pose(2.0, 0.3, 1.3), hsrv.shape_codes[0],
                hsrv.texture_codes[0], H, H, 1.1 * H, occ=grid)),
                "with occupancy, again")
            cached = hsrv._occ_grids
            ok = list(cached) == [0] and torch.equal(cached[0].occ, grid.occ)
            log(f"  occupancy grid: {list(cached)} cached, "
                f"{float(grid.occ.float().mean()):.4f} occupied, the same "
                f"cells as a fresh build: {ok}{'' if ok else '  <-- FAILS'}")
            checks.append(("one grid, the fresh build's cells", ok))
            # The trained runs' hierarchical gaps are recorded; the held
            # comparison is on served weights below (see _served_nets).
            exactness(hnet, orbit_pose(1.3, 0.3, 1.3), hsrv.shape_codes[0],
                      hsrv.texture_codes[0], H, 1.1 * H,
                      "hierarchical run (32 + 32, shared)", held=False)
        finally:
            hsrv.shutdown()
        # Phase 9's separate fine network at NeRF's 64 + 128 samples.
        fhp = load_hparams(os.path.join(work, "srncar_hier_occ_fine.json"))
        fhp = dataclasses.replace(fhp, render=dataclasses.replace(
            fhp.render, n_samples=64, n_importance=128))
        fmodel, ffine, fsc, ftc = load_run(os.path.join(exps, "fine"), fhp,
                                           dev)
        exactness((fmodel, ffine, fhp), orbit_pose(0.4, 0.2, 1.3), fsc[1],
                  ftc[1], H, 1.1 * H, "fine run at 64 + 128", held=False)
        del fmodel, ffine
        # Held: a 64 + 128 view of networks drawn as the served cells
        # draw them, with separate and with shared fine weights.
        for shared in (False, True):
            shp = dataclasses.replace(fhp, render=dataclasses.replace(
                fhp.render, share_fine_weights=shared))
            smodel, sfine, ssc, stc = _served_nets(dev, shared)
            exactness((smodel, sfine, shp), orbit_pose(2.6, 0.35, 1.3), ssc,
                      stc, H, 1.1 * H, "served 64 + 128, "
                      f"{'shared' if shared else 'separate'} fine weights")
        del smodel, sfine
        hier_chunks = render_image.chunks["kernels"] - hier_chunks

        out = os.path.join(work, "export", "models.pth")
        ckpt_dir = os.path.join(exps, "smoke", "ckpt")
        export_reference_checkpoint.main([ckpt_dir, out])
        ck = read_checkpoint(ckpt_dir)
        sd, sc, tc = load_reference_checkpoint(out)
        ok = (sd.keys() == ck["model"].keys()
              and all(torch.equal(sd[k], ck["model"][k].float()) for k in sd)
              and torch.equal(sc, ck["shape_codes"].float())
              and torch.equal(tc, ck["texture_codes"].float()))
        log(f"  export of step {ck['step']}: {len(sd)} tensors and both code "
            f"tables read back {'bit-equal' if ok else 'DIFFERENT'}"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append(("export read back", ok))
        try:
            export_reference_checkpoint.export(
                os.path.join(exps, "fine", "ckpt"),
                os.path.join(work, "export", "fine.pth"))
            refused = "no error"
        except ValueError as e:
            refused = str(e)
        ok = "fine network" in refused
        log(f"  export of the separate-fine run: {refused[:90]}"
            f"{'' if ok else '  <-- FAILS'}")
        checks.append(("export refuses a fine network", ok))

        res = edit.main(["--saved_dir", "smoke", "--jsonfile", coarse_json,
                         "--exps_root", exps, "--objects", "0", "1",
                         "--grid", "3", "--device", device])
        ds = SRNDataset(cat=hp.data.cat, splits=hp.data.splits,
                        data_dir=hp.data.data_dir, max_objects=2)
        h, w = ds.images.shape[2:4]
        for j in range(2):
            want = direct(net, ds.poses[0, 0], srv.shape_codes[j],
                          srv.texture_codes[j], h, w, float(ds.focals[0]),
                          chunk=min(4096, h * w)).cpu().numpy()
            ok = np.array_equal(res["matrix"][j, j], want)
            log(f"  edit: swap matrix ({res['matrix'].shape[:2]}) diagonal "
                f"{j} {'equal to' if ok else 'DIFFERS from'} the direct "
                f"render{'' if ok else '  <-- FAILS'}")
            checks.append((f"edit diagonal {j}", ok))
        odir = render_orbit.main([
            "--saved_dir", "smoke", "--jsonfile", coarse_json, "--exps_root",
            exps, "--n_frames", "4", "--H", str(H), "--W", str(H), "--out",
            os.path.join(work, "orbit"), "--device", device])
        names = sorted(os.listdir(odir))
        ok = names == ["frame_000.png", "frame_001.png", "frame_002.png",
                       "frame_003.png", "orbit.gif"]
        log(f"  render_orbit: {names}{'' if ok else '  <-- FAILS'}")
        checks.append(("render_orbit frames", ok))
        r = estimate_bound_radius.main([
            "--saved_dir", "smoke", "--jsonfile", coarse_json, "--exps_root",
            exps, "--device", device])
        checks.append(("estimated radius", bool(np.isfinite(r) and r > 0)))
        counts = lc.get()
        launched = {k: v for k, v in counts.items() if v}
        kernel_chunks = render_image.chunks["kernels"] - kernel_chunks
        # Every render through the kernels here is H x H in chunks of
        # 4096; the hierarchical ones (phase 5's run and phase 9's at
        # 64 + 128) launch the sigma-only forward besides.
        per_view = chunk_plan(H * H, 4096)[1]
        views = kernel_chunks // per_view
        launches = views * _kernel_launches(H * H, 4096)
        hier = hier_chunks // per_view * _kernel_launches(H * H, 4096)
        # one pack for each tool's coarse model, the hierarchical server's
        # model, phase 9's two networks and the served draws' three
        want = {"sigma": hier, "planes": launches, "composite": launches,
                "pack": 9}
        checks.append(("the forward kernels' launches alone",
                       views > 0 and views * per_view == kernel_chunks
                       and hier > 0 and launched == want
                       and not lc.plain_on_cuda))
        log(f"  launches in phase 15: {launched or 'none'} ({kernel_chunks} "
            f"chunks, {views} views through the forward kernels, "
            f"{hier_chunks} chunks hierarchical; expected {want})")
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError(f"phase 15 failed: {failed}")
    return lat


QUALITY_STEPS = 1000


def _quality_spread(got: list, want: list) -> tuple:
    """The largest differences of two runs' rows: held-out PSNR, SSIM,
    fitting start and end PSNR."""
    return tuple(max(abs(g[i] - w[i]) for g, w in zip(got, want))
                 for i in (1, 2, 3, 4))


def quality_path(work: str, device: str = "cuda", steps: int = QUALITY_STEPS,
                 n_train: int = 16, n_test: int = 4, n_views: int = 24,
                 size: int = 64, batch: int = 8192, num_opts: int = 200,
                 net=None, group: int = 4, opt_rays: int = 1024) -> dict:
    """Phase 14: ``codenerf_tpu_torch.quality_report``'s path on seed 0,
    cut to ``steps`` training steps, at the flagship widths with the
    fused single pass at 96 samples (``net`` overrides the widths for a
    CPU rehearsal). Then the held-out objects are fitted twice more on the
    trained checkpoint (``--resume_train``): sequentially again, with
    ``--opt_group`` and with ``--opt_rays``. Fails on a non-finite value,
    a training PSNR that does not rise from the first logged step to the
    last, an object whose fitting ends at or below its start, two
    sequential fits of the checkpoint (the first run's and the rerun)
    whose codes are not the same bits (every sum of the fitting kernel
    runs in a fixed order), or a batched object off the sequential rerun:
    its fitting start PSNR (the first step's loss: the same data, draws
    and route) by more than 1e-4 dB, its held-out PSNR by more than 0.01
    dB or its SSIM by more than 1e-3; whether its codes are the same bits
    is printed. A fault of the batched loop (another object's rows, draws
    or loss scale) moves a held-out PSNR by tenths. Each run counts its launches
    in its own window: one ``train`` and one ``pack`` a training step, one
    ``codes`` a fitting step and object, one ``pack`` a fitting run, two
    ``code_rows`` a training step (one a code table); the eval renders
    ``n_views`` - 1 views of each held-out object, on the card every
    chunk on the forward kernels' route (``renderer.kernel_route``: one
    ``planes`` and one ``composite`` a launch, ``_kernel_launches`` a
    view), else on the plain module's."""
    import numpy as np

    from codenerf_tpu_torch import quality_report
    from codenerf_tpu_torch.renderer import chunk_plan, render_image

    out = os.path.join(work, "quality")
    base = ["--use_fused", "--samples", "96", "--steps", str(steps),
            "--num_opts", str(num_opts), "--n_train_objects", str(n_train),
            "--n_test_objects", str(n_test), "--n_views", str(n_views),
            "--size", str(size), "--seeds", "0", "--save_images", "0",
            "--out", out, "--device", device]
    on_card = device != "cpu"
    # The eval renders every view of each held-out object but the fitted
    # one (--tgt_views, default "1"): one render_image of size x size.
    n_eval = n_test * (n_views - 1)
    runs = {}
    for what, extra, want in (
            ("sequential", [], {"train": steps, "pack": steps + 1,
                                "code_rows": 2 * steps,
                                "codes": n_test * num_opts}),
            ("sequential rerun", ["--resume_train"],
             {"pack": 1, "codes": n_test * num_opts}),
            (f"--opt_group {group}", ["--resume_train", "--opt_group",
                                      str(group)],
             {"pack": 1, "codes": n_test * num_opts}),
            (f"--opt_rays {opt_rays}", ["--resume_train", "--opt_rays",
                                        str(opt_rays)],
             {"pack": 1, "codes": n_test * num_opts}),
            (_device_arms(group)[0], ["--resume_train", "--opt_group",
                                      str(group), "--scene_backend",
                                      "device"],
             {"pack": 1, "codes": n_test * num_opts}),
            (_device_arms(group)[1], ["--resume_train", "--opt_group",
                                      str(group), "--scene_backend",
                                      "device", "--device_gt"],
             {"pack": 1, "codes": n_test * num_opts})):
        args = quality_report.build_parser().parse_args(base + extra)
        t0 = time.perf_counter()
        chunks0 = dict(render_image.chunks)
        with LaunchCounts() as lc:
            res = quality_report.run_once(args, 0, out, net=net,
                                          batch_size=batch, device=device)
            counts = lc.get()
            if lc.plain_on_cuda:
                raise AssertionError(f"{lc.plain_on_cuda} plain-version "
                                     f"calls on CUDA tensors ({what})")
        if _route_chunks(chunks0, n_eval * chunk_plan(size * size, 4096)[1],
                         on_card, f"quality {what} eval"):
            launches = n_eval * _kernel_launches(size * size, 4096)
            want = dict(want, planes=launches, composite=launches)
        log(f"  quality {what}: launches "
            f"{ {k: v for k, v in counts.items() if v} } (expected "
            f"{ {k: v * on_card for k, v in want.items()} }); "
            f"{time.perf_counter() - t0:.1f} s host clock; training "
            f"{res['train_s']:.1f} s, fitting "
            f"{[round(s, 3) for s in res['fit_s']]} s an object, eval "
            f"{[round(s, 3) for s in res['eval_s']]} s an object")
        _expect(counts, {k: v * on_card for k, v in want.items()},
                f"quality {what}")
        for name, p, s, h0, h1 in res["rows"]:
            log(f"  quality {what}: {name} fit {h0:.3f} -> {h1:.3f} dB, "
                f"held-out PSNR {p:.4f} dB, SSIM {s:.5f}")
            if not np.isfinite([p, s, h0, h1]).all() or not h1 > h0:
                raise AssertionError(f"quality {what}: {name} fit {h0} -> "
                                     f"{h1}, held-out {p} / {s}")
        log(f"  quality {what}: mean held-out PSNR {res['psnr']:.4f} dB, "
            f"SSIM {res['ssim']:.5f}")
        runs[what] = res
    seq = runs["sequential"]
    logged = [(r["step"], r["psnr/train"]) for r in _metrics(seq["run_dir"])
              if "psnr/train" in r]
    log(f"  quality: training PSNR by logged step {logged} (host wall "
        f"{seq['train_s']:.1f} s for {steps} steps of {batch} rays)")
    if (len(logged) < 2 or not np.isfinite([v for _, v in logged]).all()
            or not logged[-1][1] > logged[0][1]):
        raise AssertionError(f"training PSNR does not rise: {logged}")
    rerun = runs["sequential rerun"]["rows"]
    same = {}
    for what in ("sequential", f"--opt_group {group}"):
        d = _quality_spread(runs[what]["rows"], rerun)
        pairs = list(zip(runs[what]["codes"],
                         runs["sequential rerun"]["codes"]))
        same[what] = all(np.array_equal(a, b) for p in pairs
                         for a, b in zip(*p))
        code_d = max(float(np.abs(a - b).max()) for p in pairs
                     for a, b in zip(*p))
        log(f"  quality: {what} against the sequential rerun, largest "
            f"differences: held-out PSNR {d[0]:.6f} dB, SSIM {d[1]:.7f}, "
            f"fitting start {d[2]:.6f} dB, end {d[3]:.6f} dB; fitted codes "
            f"{'bit-equal' if same[what] else f'differ by up to {code_d:.3e}'}")
    if not same["sequential"]:
        raise AssertionError("two sequential fits of one checkpoint gave "
                             "different codes")
    d = _quality_spread(runs[f"--opt_group {group}"]["rows"], rerun)
    if not (d[0] <= 0.01 and d[1] <= 1e-3 and d[2] <= 1e-4):
        raise AssertionError(f"--opt_group {group}: rows off the "
                             f"sequential rerun's by {d}")
    device_gt_check(runs, group)
    return runs


def _device_arms(group: int) -> tuple:
    """The names of phase 14's device-scene arms."""
    scene = f"--opt_group {group} --scene_backend device"
    return scene, f"{scene} --device_gt"


def device_gt_check(runs: dict, group: int) -> None:
    """Phase 14's device-scene arms: the fits of ``--device_gt`` are
    those of the device-scene arm, the same codes bit for bit (fitting
    repeats on the card, and both fit the same device-rendered target
    views), so only the eval's ground truth differs: rendered on the card
    from the generation parameters, or the scene's stored pixels. Every
    object's held-out PSNR must be within 0.02 dB and its SSIM within
    1e-3 of the pixel truth's (JAX's bar,
    ``tests/test_optimization.py:557-558``)."""
    import numpy as np

    arms = _device_arms(group)
    a, b = (runs[k] for k in arms)
    for what in (f"--opt_group {group}",) + arms:
        r = runs[what]
        log(f"  quality {what}: mean held-out PSNR {r['psnr']:.4f} dB, "
            f"SSIM {r['ssim']:.5f}; eval {np.mean(r['eval_s']):.3f} s an "
            "object (host clock)")
    d = _quality_spread(b["rows"], a["rows"])
    same = all(np.array_equal(x, y) for p in zip(a["codes"], b["codes"])
               for x, y in zip(*p))
    log(f"  quality: device ground truth against the device scene's "
        f"pixels, largest differences: held-out PSNR {d[0]:.6f} dB, SSIM "
        f"{d[1]:.7f}, fitting start {d[2]:.6f} dB, end {d[3]:.6f} dB; "
        f"fitted codes {'bit-equal' if same else 'differ'}")
    if not (same and d[0] <= 0.02 and d[1] <= 1e-3 and d[2] == d[3] == 0):
        raise AssertionError(f"--device_gt off the device scene's pixel "
                             f"truth by {d} (codes bit-equal: {same})")


# Phase 16: the test split of the full-scale chair protocol, seed 0
# (docs/QUALITY_SYNTHETIC.md:447-457: 704 test chairs x 250 views at
# 128x128, patterned, the quality report's --cam_distance; its test draw
# is scene seed 11 + 100 * 0 + 57).
FULL_SPLIT = dict(n_objects=704, n_views=250, H=128, W=128, seed=68,
                  pattern=True, geometry="chair", cam_distance=4.0)
SAMPLER_BATCHES = 200


def _host_memory() -> str:
    try:
        return subprocess.run(["free", "-g"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"free -g did not run: {e}"


def _copy_rates(dev, H: int, W: int, chunk: int = 2048,
                reps: int = 8) -> dict:
    """GB/s of a (chunk, H, W, 3) uint8 copy from the card into a host
    array over ``reps`` chunks (host clock): pageable (``copy_`` into the
    array) and staged (into pinned memory, then into the array), each into
    a fresh array (first-touch page faults included, as the renderer's
    result takes them) and into one already written; and the card to
    pinned memory alone (CUDA events)."""
    import numpy as np
    import torch

    src = torch.randint(0, 255, (chunk, H, W, 3), dtype=torch.uint8,
                        device=dev)
    pinned = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
    rates = {}
    for touched in (False, True):
        for staged in (False, True):
            out = np.empty((reps * chunk, H, W, 3), np.uint8)
            if touched:
                out.fill(1)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for k in range(reps):
                dst = out[k * chunk:(k + 1) * chunk]
                if staged:
                    pinned.copy_(src)
                    dst[:] = pinned.numpy()
                else:
                    torch.from_numpy(dst).copy_(src)
            rates[("written " if touched else "fresh ")
                  + ("staged" if staged else "pageable")] = (
                out.nbytes / (time.perf_counter() - t0) / 1e9)
            if not np.array_equal(out[-chunk:], src.cpu().numpy()):
                raise AssertionError("copy check failed")
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    for _ in range(reps):
        pinned.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    rates["card to pinned"] = (reps * src.numel()
                               / (begin.elapsed_time(end) / 1e3) / 1e9)
    return rates


def _staging_ab(dev, split: dict, n_obj: int = 100) -> None:
    """The renderer's copy through its two pinned staging buffers against
    a plain pageable copy of each chunk into the result, on the first
    ``n_obj`` objects' draws at the split's widths, in turns (staged,
    pageable, pageable, staged), each into a fresh array; the results must
    be the same bytes."""
    import numpy as np
    import torch

    from codenerf_tpu_torch.data import synthetic as syn

    H, W, n_views = split["H"], split["W"], split["n_views"]
    d = syn._draws(n_obj, n_views, W, None, split["cam_distance"],
                   split["seed"], split["geometry"])
    c2w, albedo, geom = syn._pair_operands(d, n_obj, n_views,
                                           split["geometry"])
    args = (H, W, d["focal"], c2w, albedo, split["pattern"],
            split["geometry"])
    walls, outs = {"staged": [], "pageable": []}, []
    for staged in (True, False, False, True):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if staged:
            out = syn._render_pairs(*args, device=dev, **geom)
        else:
            out = np.empty((c2w.shape[0], H, W, 3), np.uint8)
            for s, e, images in syn._pair_chunks(*args, device=dev, **geom):
                torch.from_numpy(out[s:e]).copy_(images)
        walls["staged" if staged else "pageable"].append(
            time.perf_counter() - t0)
        outs.append(out)
    if not all(np.array_equal(o, outs[0]) for o in outs[1:]):
        raise AssertionError("staged and pageable copies differ")
    log(f"phase 16: {c2w.shape[0]} views rendered and copied to a fresh "
        f"host array, through the pinned staging buffers "
        f"{[round(w, 3) for w in walls['staged']]} s, pageable copies "
        f"{[round(w, 3) for w in walls['pageable']]} s")


def scene_path(device: str = "cuda", split: dict = FULL_SPLIT,
               samples: int = 64, gt_checks: int = 8,
               batches: int = SAMPLER_BATCHES, rays: int = R_TRAIN) -> None:
    """Phase 16. First the device scenes at full scale: ``split`` rendered
    with ``synthetic_scene(backend="device")``, its wall, the share of it
    that is not rendering (the copy to the host, through pinned staging,
    and the host's writes: 1 - the render alone over the wall), the copy
    rates pageable and staged, the peak device memory. Checks: ``samples``
    seeded (object, view) pairs against the numpy path's bytes
    (``numpy_pairs``; JAX's bar: at most one level anywhere, under 0.5%
    of pixels differ), ``params_only`` drawing the same poses and
    parameters, and ``make_gt_view_renderer`` on ``gt_checks`` of the
    pairs within 1/255 of the scene's bytes. On the card also the copy's
    rates (``_copy_rates``) and the staging against plain pageable copies
    (``_staging_ab``). Then the native sampler:
    built on this host, ``auto`` must resolve to it; ``batches`` batches
    of ``rays`` through each backend and layout on the split, rays/s,
    and the library's two calls at 1, 2, 4 and 8 threads;
    every native batch's rgb must be ``images[obj, view, v, u]`` (the
    expanded layout against the compact one of the same step, which
    draws the same picks), its pose and focal the tables' rows, and a
    crop batch's pixels inside the crop. No port kernel launches."""
    import numpy as np
    import torch

    from codenerf_tpu_torch.data import native
    from codenerf_tpu_torch.data import synthetic as syn
    from codenerf_tpu_torch.data.pipeline import RayBatchPipeline

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    H, W = split["H"], split["W"]
    n_obj, n_views = split["n_objects"], split["n_views"]
    nbytes = n_obj * n_views * H * W * 3
    log(f"phase 16: host memory before the split (free -g):\n"
        f"{_host_memory()}")
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    log(f"phase 16: the split takes {nbytes} B ({nbytes / 2 ** 30:.2f} "
        f"GiB) of uint8 on the host; {avail / 2 ** 30:.1f} GiB free")
    if avail < 2 * nbytes:
        raise AssertionError(f"phase 16 needs {2 * nbytes} B of free host "
                             f"memory, {avail} free")
    _reset_peak(device)
    with LaunchCounts() as lc:
        t0 = time.perf_counter()
        scene = syn.synthetic_scene(backend="device", device=dev, **split)
        wall = time.perf_counter() - t0
        peak = _peak(device)
        d = syn._draws(n_obj, n_views, W, None, split["cam_distance"],
                       split["seed"], split["geometry"])
        c2w, albedo, geom = syn._pair_operands(d, n_obj, n_views,
                                               split["geometry"])
        sync()
        t0 = time.perf_counter()
        for _ in syn._pair_chunks(H, W, d["focal"], c2w, albedo,
                                  split["pattern"], split["geometry"],
                                  device=dev, **geom):
            pass
        sync()
        render = time.perf_counter() - t0
        counts = lc.get()
    _expect(counts, {}, "phase 16 (device scenes)")
    images = scene["images"]
    if images.shape != (n_obj, n_views, H, W, 3) or images.nbytes != nbytes:
        raise AssertionError(f"phase 16: images {images.shape}")
    log(f"phase 16: {n_obj * n_views} views rendered on the card and "
        f"copied to the host in {wall:.3f} s ({n_obj * n_views / wall:.0f} "
        f"views/s); the render alone {render:.3f} s, so the rest (the "
        f"copy to the host, its writes there, the draws) is "
        f"{1 - render / wall:.3f} of the wall; peak device memory {peak}; "
        f"{card_line() if on_card else 'CPU'}")
    if on_card:
        rates = _copy_rates(dev, H, W)
        log("phase 16: a 2048-view chunk from the card: " + ", ".join(
            f"{k} {v:.2f} GB/s" for k, v in rates.items()))
        _staging_ab(dev, split)

    rng = np.random.default_rng(16)
    pairs = list(zip(rng.integers(0, n_obj, samples).tolist(),
                     rng.integers(0, n_views, samples).tolist()))
    t0 = time.perf_counter()
    want = syn.numpy_pairs(pairs, **split)
    numpy_s = time.perf_counter() - t0
    got = images[[p[0] for p in pairs], [p[1] for p in pairs]]
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    log(f"phase 16: {samples} seeded pairs against the numpy path "
        f"({numpy_s / samples * 1e3:.1f} ms a view on the host): largest "
        f"difference {diff.max()} level(s), {(diff > 0).mean():.6f} of "
        f"pixels differ")
    if diff.max() > 1 or (diff > 0).mean() >= 5e-3:
        raise AssertionError(f"phase 16: the device scene is off the "
                             f"numpy path by {diff.max()} levels on "
                             f"{(diff > 0).mean()} of pixels")
    params = syn.synthetic_scene(params_only=True, **split)
    for k, v in params.items():
        if isinstance(v, np.ndarray) and not np.array_equal(v, scene[k]):
            raise AssertionError(f"phase 16: params_only draws other {k}")
    gt_view = syn.make_gt_view_renderer(H, W, split["pattern"],
                                        split["geometry"], dev)
    names = (("albedo", "albedos"),) + (
        (("radius", "radii"),) if split["geometry"] == "sphere"
        else (("boxes", "boxes"), ("yaw", "yaws")))
    leaves = {k: torch.from_numpy(np.asarray(params[src], np.float32)).to(dev)
              for k, src in names}
    worst = 0.0
    for o, v in pairs[:gt_checks]:
        gt = gt_view(torch.from_numpy(params["poses"][o, v]).to(dev),
                     torch.tensor(params["focals"][o]).to(dev),
                     {k: x[o] for k, x in leaves.items()}).cpu().numpy()
        worst = max(worst, float(np.abs(
            gt - images[o, v].astype(np.float32) / 255.0).max()))
    log(f"phase 16: params_only draws the same poses and parameters; "
        f"make_gt_view_renderer on {gt_checks} pairs within {worst:.7f} "
        f"of the scene's bytes / 255")
    if worst > 1.0 / 255.0 + 1e-6:
        raise AssertionError(f"phase 16: device ground truth off by {worst}")

    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError(f"the native sampler did not build: "
                             f"{native.build_error()}")
    log(f"phase 16: native sampler {native.library_path().name} built and "
        f"loaded on this host in {time.perf_counter() - t0:.2f} s")
    poses, focals = scene["poses"], scene["focals"]
    backend = RayBatchPipeline(images, poses, focals, backend="auto").backend
    if backend != "native":
        raise AssertionError(f"backend='auto' resolved to {backend!r}")
    got = {}
    for name in ("numpy", "native"):
        for compact in (False, True):
            pipe = RayBatchPipeline(images, poses, focals, seed=0,
                                    backend=name)
            t0 = time.perf_counter()
            out = [pipe.sample(rays, compact=compact) for _ in range(batches)]
            s = time.perf_counter() - t0
            layout = "compact" if compact else "expanded"
            log(f"phase 16: sampler {name}, {layout} layout: {batches} "
                f"batches of {rays} rays in {s:.3f} s, "
                f"{batches * rays / s:.0f} rays/s (host, {os.cpu_count()} "
                "CPUs)")
            got[name, compact] = out
    for threads in (1, 2, 4, 8):
        for fn in (native.sample_batch, native.sample_batch_compact):
            t0 = time.perf_counter()
            for step in range(batches // 4):
                fn(images, poses, focals, rays, 0, step, 0, H, 0, W,
                   n_threads=threads)
            s = time.perf_counter() - t0
            log(f"phase 16: native.{fn.__name__} at n_threads={threads}: "
                f"{batches // 4 * rays / s:.0f} rays/s")
    tables = {"c2w": poses[:, :, :3], "focal": focals}
    for k, (full, comp) in enumerate(zip(got["native", False],
                                         got["native", True])):
        o, v = comp["obj"], comp["view"]
        u, w = comp["uv"][:, 0], comp["uv"][:, 1]
        px = images[o, v, w, u]
        if not (np.array_equal(comp["rgb"], px)
                and np.array_equal(full["obj"], o)
                and np.array_equal(full["uv"], comp["uv"].astype(np.float32))
                and np.array_equal(full["rgb"],
                                   px.astype(np.float32)
                                   * np.float32(1.0 / 255.0))
                and np.array_equal(full["c2w"], tables["c2w"][o, v])
                and np.array_equal(full["focal"], tables["focal"][o])):
            raise AssertionError(f"phase 16: native batch {k} does not "
                                 "gather images[obj, view, v, u]")
    pipe = RayBatchPipeline(images, poses, focals, seed=1, backend="native")
    v0, v1, u0, u1 = pipe._pixel_bounds(True)
    for _ in range(8):
        uv = pipe.sample(rays, crop=True, compact=True)["uv"]
        if not (uv[:, 0].min() >= u0 and uv[:, 0].max() < u1
                and uv[:, 1].min() >= v0 and uv[:, 1].max() < v1):
            raise AssertionError("phase 16: a crop batch left the crop")
    log(f"phase 16: every native batch gathers images[obj, view, v, u] and "
        f"the pose and focal tables; crop batches stay in [{v0}, {v1}) x "
        f"[{u0}, {u1})")


MESH_STEPS = 3        # phase 17(b): data-parallel steps on two ranks
MESH_OBJS = 4         # phase 17(b): objects fitted on two ranks
MESH_TIMED = 5        # phase 17(a): steps a timing window
TP_RAYS = 4096        # phase 17(c): rays a model-axis step


class _Env:
    """``os.environ`` with ``values`` set inside the block and as it was
    after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def _mesh_inputs(jsonfile: str, dev):
    """The flagship config's training state from its seed, two pipelines
    of one seed (each rank's rows and the whole batch), the pose tables
    on ``dev``, and the 4-object test set."""
    import torch

    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.training.state import create_train_state

    hp = load_hparams(jsonfile)
    ds = SRNDataset(cat=hp.data.cat, splits=hp.data.splits,
                    data_dir=hp.data.data_dir)
    test = SRNDataset(cat=hp.data.cat, splits="cars_test",
                      data_dir=hp.data.data_dir)
    pipes = [RayBatchPipeline(ds.images, ds.poses, ds.focals, seed=hp.seed)
             for _ in range(2)]
    tables = {k: torch.from_numpy(v).to(dev)
              for k, v in pipes[0].tables().items()}
    return hp, create_train_state(hp, ds.n_objects, dev), pipes, tables, test


def _staged_batch(pipe, batch: int, tables, dev, shard=None):
    """The pipeline's next compact batch on ``dev``, expanded."""
    import torch

    from codenerf_tpu_torch.training.train_step import expand_compact_batch

    b = pipe.sample(batch, compact=True, shard=shard)
    return expand_compact_batch({k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()}, tables)


def _whole_z(hp, batch: int, dev, seed: int):
    """Sorted depths for a whole batch from a seeded generator on ``dev``:
    the same numbers on every rank."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = hp.render
    z = torch.rand((batch, r.n_samples), generator=g, device=dev)
    return torch.sort(r.near + (r.far - r.near) * z, dim=-1).values


def _grad_step(fn, state, batch, z):
    """One ``grad_fn`` pass from zeroed gradients: (loss, every
    trainable's gradient, cloned)."""
    from codenerf_tpu_torch.training.train_step import trainable_params

    state.optimizer.zero_grad(set_to_none=True)
    m = fn(state, batch, z=z)
    return m["loss"].detach().clone(), [p.grad.detach().clone()
                                        for p in trainable_params(state)]


def _same_step(what: str, got, want, bits: bool = False) -> None:
    """A meshed step's loss and every gradient against one process's at
    ``_close``'s bars (a miss is logged and fails); logs the loss's
    relative difference and the largest relative L2 error of a
    gradient. ``bits``: the loss and every gradient must also be the same
    bits (every sum of the step runs in a fixed order, the code tables'
    gradients included: ``ops/code_rows.py``)."""
    import torch

    if bits:
        same = torch.equal(got[0], want[0]) and all(
            torch.equal(g, w) for g, w in zip(got[1], want[1]))
        log(f"  {what}: loss and {len(got[1])} gradients "
            f"{'the same bits' if same else 'NOT the same bits'} as one "
            f"process's{'' if same else '  <-- FAILS'}")
        if not same:
            raise AssertionError(f"{what}: not the one-process step's bits")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if not _close(f"{what} gradient {i}", g.reshape(-1), w.reshape(-1),
                      quiet=True)[1]:
            raise AssertionError(f"{what}: gradient {i} off the one-process "
                                 "step")
        worst = max(worst, float(torch.linalg.vector_norm(g - w)
                                 / torch.linalg.vector_norm(w).clamp_min(
                                     1e-30)))
    rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    log(f"  {what}: loss {float(got[0]):.7f} against {float(want[0]):.7f} "
        f"(relative {rel:.2e}); {len(got[1])} gradients within _close's "
        f"bars, the largest relative L2 error {worst:.3e}")
    if not rel < 1e-4:
        raise AssertionError(f"{what}: loss off the one-process step")


def _weights_sum(state):
    """A checksum of every trainable's bits (``_bits_sum``)."""
    from codenerf_tpu_torch.training.train_step import trainable_params

    return _bits_sum(trainable_params(state))


def _bits_sum(tensors):
    """A checksum of the tensors' bits (int64, position-weighted)."""
    import torch

    bits = torch.cat([t.detach().reshape(-1).float().view(torch.int32)
                      for t in tensors]).long()
    return (bits * torch.arange(1, bits.numel() + 1,
                                device=bits.device)).sum()


def _fit(hp, state, test, dev, mesh, num_opts: int, seed: int):
    """``MESH_OBJS`` test objects fitted together (``num_opts`` steps,
    chunks of 4096) and scored on their other views, on ``mesh`` or on one
    process, from the state's model and mean codes."""
    import copy

    import torch

    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer

    opt = CodeOptimizer(copy.deepcopy(state.model), hp,
                        state.shape_codes.detach().mean(0),
                        state.texture_codes.detach().mean(0), chunk=4096,
                        device=dev, mesh=mesh)
    args = (test.images[:MESH_OBJS], test.poses[:MESH_OBJS],
            test.focals[:MESH_OBJS])

    def gens(base):
        return [torch.Generator(device=dev).manual_seed(base + g)
                for g in range(MESH_OBJS)]

    res = opt.optimize_objects(*args, [0], gens(seed), num_opts=num_opts)
    ev = opt.evaluate_objects(*args, [0], res.shape_codes,
                              res.texture_codes, gens(seed + 100))
    return res, ev


def _same_fit(what: str, got, want) -> None:
    import numpy as np
    import torch

    (res, ev), (res1, ev1) = got, want
    same = (torch.equal(res.shape_codes, res1.shape_codes)
            and torch.equal(res.texture_codes, res1.texture_codes)
            and np.array_equal(res.psnr_history, res1.psnr_history)
            and np.array_equal(ev["psnr"], ev1["psnr"])
            and np.array_equal(ev["ssim"], ev1["ssim"]))
    log(f"  {what}: codes, PSNR history and eval PSNR/SSIM of "
        f"{res.shape_codes.shape[0]} objects "
        f"{'the same bits as' if same else 'OFF'} the unsharded run's; "
        f"eval PSNR {np.round(ev['psnr'].mean(1), 4).tolist()}")
    if not same:
        raise AssertionError(f"{what}: the sharded fit is not the "
                             "unsharded one")


def mesh_nccl(work: str, jsonfile: str, device: str, batch: int, H: int,
              num_opts: int) -> None:
    """Phase 17(a): world size 1 through ``init_from_env`` (nccl on the
    card, gloo on the CPU) and ``make_mesh(data=1)``."""
    import torch
    import torch.distributed as dist

    from codenerf_tpu_torch.parallel import mesh as pm
    from codenerf_tpu_torch.training import train_step as ts

    with _Env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0"):
        dev = pm.init_from_env(device,
                               init_method=f"file://{work}/pg_world1")
    try:
        mesh = pm.make_mesh(data=1)
        group = pm.batch_group(mesh)
        hp, state, pipes, tables, test = _mesh_inputs(jsonfile, dev)
        b = _staged_batch(pipes[0], batch, tables, dev)
        z = _whole_z(hp, batch, dev, seed=17)
        want = _grad_step(ts.build_grad_fn(hp, H, H, batch_size=batch),
                          state, b, z)
        with LaunchCounts() as lc:
            got = _grad_step(ts.build_grad_fn(hp, H, H, batch_size=batch,
                                              mesh=mesh), state, b, z)
            counts = lc.get()
        _same_step(f"17(a) {dist.get_backend()} world 1 vs no mesh", got,
                   want, bits=True)
        _expect(counts, {"train": 1, "code_rows": 2}
                if dev.type == "cuda" else {}, "17(a) meshed step")
        floats = sum(g.numel() for g in want[1]) + 3
        log(f"  17(a): {floats * 4} B all-reduced a step ({floats - 3} "
            f"gradient and 3 metric f32)")
        steps = {False: ts.build_train_step(hp, H, H, batch_size=batch),
                 True: ts.build_train_step(hp, H, H, batch_size=batch,
                                           mesh=mesh)}
        staged = {k: v for k, v in pipes[0].sample(batch,
                                                   compact=True).items()}
        staged = {k: torch.from_numpy(v).to(dev) for k, v in staged.items()}
        if dev.type == "cuda":
            ms = {False: [], True: []}
            for meshed in (False, True, True, False):
                fn = steps[meshed]
                fn(state, staged, tables)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(MESH_TIMED):
                    fn(state, staged, tables)
                torch.cuda.synchronize()
                ms[meshed].append((time.perf_counter() - t0) * 1e3
                                  / MESH_TIMED)
            buf = torch.zeros(floats, device=dev)
            ar = time_cuda(lambda: dist.all_reduce(buf, group=group), 50, 5)
            parts = [torch.zeros_like(g) for g in want[1]] + [
                torch.zeros(3, device=dev)]
            mean_ms = time_cuda(lambda: pm.all_reduce_mean_(parts, group),
                                50, 5)
            log(f"  17(a): nccl all_reduce of the {floats * 4} B bucket "
                f"{ar:.4f} ms, all_reduce_mean_ (flatten, reduce, divide, "
                f"copy back) {mean_ms:.4f} ms, each back to back by CUDA "
                f"events; training step ms (host clock, {MESH_TIMED} "
                f"steps a window, in turns no mesh, mesh, mesh, no mesh): "
                f"no mesh {ms[False]}, mesh {ms[True]}; {card_line()}")
            from torch.profiler import ProfilerActivity, profile

            for meshed in (False, True):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(MESH_TIMED):
                        steps[meshed](state, staged, tables)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / MESH_TIMED
                log_step_profile(
                    f"17(a) {'mesh' if meshed else 'no mesh'} train",
                    sum(ms[meshed]) / 2, wall, prof, MESH_TIMED,
                    packs_per_step=1)
        else:
            for meshed in (False, True):
                steps[meshed](state, staged, tables)
            log("  17(a): all_reduce and step ms not measured (CPU)")
        with LaunchCounts() as lc:
            got = _fit(hp, state, test, dev, mesh, num_opts, seed=300)
            counts = lc.get()
        _same_fit("17(a) world-1 mesh", got,
                  _fit(hp, state, test, dev, None, num_opts, seed=300))
        log(f"  17(a): fitting launches "
            f"{ {k: v for k, v in counts.items() if v} }")
    finally:
        dist.destroy_process_group()


def mesh_cli(work: str, jsonfile: str, device: str, batch: int) -> None:
    """Phase 17(a)'s CLI: ``torchrun --standalone --nproc_per_node 1 -m
    codenerf_tpu_torch.train ... --data_axis 1`` for 2 steps."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    exps = os.path.join(work, "exps")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "codenerf_tpu_torch.train",
           "--jsonfile", jsonfile, "--exps_root", exps, "--save_dir",
           "torchrun", "--batchsize", str(batch), "--iters_crop", "1",
           "--iters_all", "2", "--log_every", "1", "--check_iter", "0",
           "--data_axis", "1", "--device", device]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"torchrun train failed ({out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    run = os.path.join(exps, "torchrun")
    losses = _losses(run)
    if [s_ for s_, _ in losses] != [1, 2] or not np.isfinite(
            [v for _, v in losses]).all():
        raise AssertionError(f"torchrun train logged {losses}")
    if "step_00000002.pt" not in os.listdir(os.path.join(run, "ckpt")):
        raise AssertionError("torchrun train wrote no step-2 checkpoint")
    log(f"  17(a): torchrun --nproc_per_node 1 train --data_axis 1: 2 "
        f"steps, losses {losses}, {wall:.1f} s of command incl. start-up")


def _gloo_rank(rank: int, work: str, jsonfile: str, device: str, batch: int,
               H: int, num_opts: int, steps: int) -> None:
    """One of phase 17(b)'s two ranks, both on ``device`` (the card's
    cuda:0), joined over gloo; writes ``<work>/mesh_rank<r>.json``."""
    import torch

    from codenerf_tpu_torch.ops import fused_train
    from codenerf_tpu_torch.parallel import mesh as pm
    from codenerf_tpu_torch.training import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    dev = pm.init_from_env(device, backend="gloo",
                           init_method=f"file://{work}/pg_gloo")
    try:
        mesh = pm.make_mesh()
        group = pm.batch_group(mesh)
        shard = pm.batch_shard(mesh)
        hp, state, pipes, tables, test = _mesh_inputs(jsonfile, dev)
        meshed = ts.build_grad_fn(hp, H, H, batch_size=batch, mesh=mesh)
        plain = ts.build_grad_fn(hp, H, H, batch_size=batch)
        report = {"rank": rank, "shard": shard, "counts": {}, "points": 0,
                  "step_s": []}
        for step in range(steps):
            local = _staged_batch(pipes[0], batch, tables, dev, shard)
            whole = _staged_batch(pipes[1], batch, tables, dev)
            z = _whole_z(hp, batch, dev, seed=100 + step)
            want = _grad_step(plain, state, whole, z) if rank == 0 else None
            with LaunchCounts() as lc:
                t0 = time.perf_counter()
                got = _grad_step(meshed, state, local, z)
                ts.apply_update(state, hp)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                report["step_s"].append(time.perf_counter() - t0)
                _add(report["counts"], lc.get())
                report["points"] += fused_train.train_fused.points["train"]
            if rank == 0:
                _same_step(f"17(b) step {step} rank 0 (whole batch "
                           f"{batch}, {batch // 2} a rank) vs one process",
                           got, want)
            sums = pm.all_gather_cat(_weights_sum(state)[None], group)
            if not bool((sums == sums[0]).all()):
                raise AssertionError(f"17(b) step {step}: the ranks' "
                                     f"weights differ: {sums.tolist()}")
        with LaunchCounts() as lc:
            got = _fit(hp, state, test, dev, mesh, num_opts, seed=400)
            report["fit_counts"] = lc.get()
        if rank == 0:
            _same_fit("17(b) 2 gloo ranks", got,
                      _fit(hp, state, test, dev, None, num_opts, seed=400))
        with open(os.path.join(work, f"mesh_rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def mesh_gloo(work: str, jsonfile: str, device: str, batch: int, H: int,
              num_opts: int, steps: int = MESH_STEPS) -> None:
    """Phase 17(b): two spawned ranks on one card over gloo."""
    import torch.multiprocessing as mp

    from codenerf_tpu_torch.renderer import chunk_plan

    mp.spawn(_gloo_rank, args=(work, jsonfile, device, batch, H, num_opts,
                               steps), nprocs=2, join=True)
    on_card = device != "cpu"
    _, chunks, _ = chunk_plan(H * H, 4096)
    for rank in range(2):
        with open(os.path.join(work, f"mesh_rank{rank}.json")) as f:
            r = json.load(f)
        ran = {k: v for k, v in r["counts"].items() if v}
        fit = {k: v for k, v in r["fit_counts"].items() if v}
        log(f"  17(b) rank {rank} (batch shard {r['shard']}): launches "
            f"{ran} in {steps} data-parallel steps at "
            f"{r['points']} points ({batch // 2} rays x "
            f"{r['points'] // max(1, batch // 2 * steps)} samples a step); "
            f"fitting launches {fit}; step s (host clock, a "
            f"correctness run: two ranks share one card) "
            f"{[round(x, 4) for x in r['step_s']]}")
        _expect({k: r["counts"].get(k, 0) for k in ("train", "code_rows")},
                {"train": steps * on_card, "code_rows": 2 * steps * on_card},
                f"17(b) rank {rank} training")
        n = MESH_OBJS // 2 * num_opts * chunks
        _expect({"codes": r["fit_counts"].get("codes", 0)},
                {"codes": n * on_card}, f"17(b) rank {rank} fitting")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _tp_rank(rank: int, work: str, jsonfile: str, fused: str, hier: list,
             device: str, batch: int, H: int, steps: int) -> None:
    """One of phase 17(c)'s two ranks at ``(data=1, model=2)``, both on
    ``device`` over gloo: ``steps`` autodiff steps of the sharded state
    (rank 0 keeps each step's whole weights, batch, depths, loss and
    gathered gradients, then holds one process's step from the same
    weights against them); the replicated leaves' bits across the ranks;
    rank 0's checkpoint in one process; one step of each ``hier``
    config, held the same way; the fused config's refusal. Writes
    ``<work>/tp_rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.parallel import mesh as pm
    from codenerf_tpu_torch.training import train_step as ts
    from codenerf_tpu_torch.training.state import (create_train_state,
                                                   named_trainables)
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    dev = pm.init_from_env(device, backend="gloo",
                           init_method=f"file://{work}/pg_tp")
    try:
        mesh = pm.make_mesh(data=1, model=2)
        hp, one, pipes, tables, _ = _mesh_inputs(jsonfile, dev)
        try:
            ts.build_grad_fn(load_hparams(fused), H, H, batch_size=batch,
                             mesh=mesh)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        if refusal is None or "'model' (tensor-parallel)" not in refusal:
            raise AssertionError(f"17(c): srncar_fused.json with model = 2 "
                                 f"did not raise JAX's ValueError: "
                                 f"{refusal}")
        _reset_peak(device)
        state = create_train_state(hp, one.shape_codes.shape[0], dev,
                                   mesh=mesh)
        sh = state.shards
        mine = named_trainables(state)
        sharded = [n for n in mine if sh.dims[n] is not None]
        report = {"rank": rank, "refusal": refusal, "sharded": len(sharded),
                  "leaves": len(mine), "step_s": [],
                  "gathered_bytes": 4 * (sh.size - 1) * sum(
                      mine[n].numel() for n in sharded),
                  "state_bytes": 4 * sum(p.numel() for p in mine.values()),
                  "whole_bytes": 4 * sum(
                      p.numel() for p in named_trainables(one).values())}
        fn = ts.build_grad_fn(hp, H, H, batch_size=batch, mesh=mesh)
        shard = pm.batch_shard(mesh)
        kept = []
        with LaunchCounts() as lc:
            for step in range(steps):
                b = _staged_batch(pipes[0], batch, tables, dev, shard)
                z = _whole_z(hp, batch, dev, seed=500 + step)
                with torch.no_grad():   # copies: AdamW writes in place
                    w = {n: t.clone() for n, t in
                         sh.whole(named_trainables(state)).items()}
                state.optimizer.zero_grad(set_to_none=True)
                _sync(dev)
                t0 = time.perf_counter()
                m = fn(state, b, z=z)
                _sync(dev)
                dt = time.perf_counter() - t0
                with torch.no_grad():
                    g = {n: t.clone() for n, t in sh.whole(
                        {n: p.grad for n, p in
                         named_trainables(state).items()}).items()}
                t0 = time.perf_counter()
                ts.apply_update(state, hp)
                _sync(dev)
                report["step_s"].append(dt + time.perf_counter() - t0)
                if rank == 0:
                    kept.append((w, b, z, m["loss"].detach().clone(), g))
            report["counts"] = lc.get()
        report["peak_tp"] = _peak(device)
        # The replicated leaves: the layers narrower than 256, their
        # moments, every AdamW step count, the generator.
        leaves = []
        for n, p in named_trainables(state).items():
            st = state.optimizer.state[p]
            leaves.append(st["step"].reshape(1).to(dev))
            if sh.dims[n] is None:
                leaves += [p, st["exp_avg"], st["exp_avg_sq"]]
        leaves.append(state.generator.get_state().float().to(dev))
        sums = pm.all_gather_cat(_bits_sum(leaves)[None], dist.group.WORLD)
        if not bool((sums == sums[0]).all()):
            raise AssertionError(f"17(c): the replicated leaves differ "
                                 f"between the ranks: {sums.tolist()}")
        report["replicated"] = len(leaves)
        ck_dir = os.path.join(work, "tp_ckpt")
        ckpt.save_checkpoint(ck_dir, state, write=rank == 0)
        dist.barrier()
        with torch.no_grad():
            final = sh.whole(named_trainables(state))
        if rank == 0:
            _tp_check_ckpt(ck_dir, hp, final, state, dev)
            report["peak_one"] = _tp_reference(hp, H, batch, one, kept,
                                               device)
        report["hier"] = []
        for path in hier:
            report["hier"].append(_tp_hier_step(rank, path, mesh, pipes[0],
                                                tables, dev, batch, H))
        with open(os.path.join(work, f"tp_rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _tp_hier_step(rank: int, jsonfile: str, mesh, pipe, tables, dev,
                  batch: int, H: int) -> dict:
    """One hierarchical step of ``jsonfile`` on the model axis (the
    importance probes from the state's generator), held on rank 0
    against one process's step from the same weights, batch, depths and
    probes."""
    import torch

    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.parallel import mesh as pm
    from codenerf_tpu_torch.training import train_step as ts
    from codenerf_tpu_torch.training.state import (create_train_state,
                                                   named_trainables)

    hp = load_hparams(jsonfile)
    n_obj = tables["focal"].shape[0]
    state = create_train_state(hp, n_obj, dev, mesh=mesh)
    sh = state.shards
    b = _staged_batch(pipe, batch, tables, dev, pm.batch_shard(mesh))
    z = _whole_z(hp, batch, dev, seed=600)
    with torch.no_grad():
        w = {n: t.clone() for n, t in
             sh.whole(named_trainables(state)).items()}
    loss, _ = _grad_step(ts.build_grad_fn(hp, H, H, batch_size=batch,
                                          mesh=mesh), state, b, z)
    with torch.no_grad():
        g = sh.whole({n: p.grad for n, p in named_trainables(state).items()})
    out = {"config": os.path.basename(jsonfile),
           "fine": state.fine_model is not None,
           "sharded": sum(d is not None for d in sh.dims.values()),
           "leaves": len(sh.dims)}
    if rank == 0:
        one = create_train_state(hp, n_obj, dev)
        with torch.no_grad():
            for n, p in named_trainables(one).items():
                p.copy_(w[n])
        want = _grad_step(ts.build_grad_fn(hp, H, H, batch_size=batch),
                          one, b, z)
        _same_step(f"17(c) {out['config']} (fine network: {out['fine']}, "
                   f"{out['sharded']} of {out['leaves']} trainables "
                   f"sharded): model = 2 vs one process", (loss, list(
                       g[n] for n in named_trainables(one))), want,
                   bits=True)
    return out


def _tp_check_ckpt(ck_dir: str, hp, final, state, dev) -> None:
    """Rank 0's checkpoint restored into one process: every trainable
    the gathered state's, and each AdamW moment's block 0 rank 0's."""
    import torch

    from codenerf_tpu_torch.training.state import (create_train_state,
                                                   named_trainables)
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    sh = state.shards
    one = create_train_state(hp, final["shape_codes"].shape[0], dev)
    ckpt.restore_checkpoint(ck_dir, one)
    if one.step != state.step:
        raise AssertionError(f"17(c): checkpoint step {one.step}")
    mine = named_trainables(state)
    for n, p in named_trainables(one).items():
        if not torch.equal(p, final[n]):
            raise AssertionError(f"17(c): checkpoint {n} off the gathered "
                                 "state")
        for k in ("exp_avg", "exp_avg_sq"):
            a = one.optimizer.state[p][k]
            if sh.dims[n] is not None:
                a = sh.slice(a, sh.dims[n])
            if not torch.equal(a, state.optimizer.state[mine[n]][k]):
                raise AssertionError(f"17(c): checkpoint {n} {k} off rank "
                                     "0's")
    log(f"  17(c): rank 0's checkpoint ({len(final)} trainables whole, "
        f"AdamW moments included) restored in one process equals the "
        f"gathered state")


def _tp_reference(hp, H: int, batch: int, one, kept, device: str) -> str:
    """One process's step from each kept step's whole weights on its batch
    and depths, held against the model axis's loss (rtol 1e-4) and
    gathered gradients (``_close``); returns its peak device memory."""
    import torch

    from codenerf_tpu_torch.training import train_step as ts
    from codenerf_tpu_torch.training.state import named_trainables

    names = list(named_trainables(one))
    plain = ts.build_grad_fn(hp, H, H, batch_size=batch)
    _reset_peak(device)
    for step, (w, b, z, loss, g) in enumerate(kept):
        with torch.no_grad():
            for n, p in named_trainables(one).items():
                p.copy_(w[n])
        want = _grad_step(plain, one, b, z)
        _same_step(f"17(c) step {step}: model = 2 (gathered) vs one "
                   f"process from the same weights", (loss, [g[n] for n in
                                                          names]), want,
                   bits=True)
    return _peak(device)


def mesh_tp(work: str, jsonfile: str, fused: str, device: str, batch: int,
            H: int, steps: int = MESH_STEPS) -> None:
    """Phase 17(c): two spawned ranks at ``(data=1, model=2)`` sharing one
    card over gloo, on the autodiff route (``srncar.json``; then one step
    of ``srncar_hierarchical.json`` as it is and with a separate fine
    network)."""
    import torch.multiprocessing as mp

    hier = [_config(work, "srncar_hierarchical.json"),
            _config(work, "srncar_hierarchical.json", out="tp_fine.json",
                    hierarchical_share_weights=False)]
    mp.spawn(_tp_rank, args=(work, jsonfile, fused, hier, device, batch, H,
                             steps), nprocs=2, join=True)
    for rank in range(2):
        with open(os.path.join(work, f"tp_rank{rank}.json")) as f:
            r = json.load(f)
        ran = {k: v for k, v in r["counts"].items() if v}
        log(f"  17(c) rank {rank}: {r['sharded']} of {r['leaves']} "
            f"trainables sharded over model; state {r['state_bytes']} B "
            f"against {r['whole_bytes']} B whole; {r['gathered_bytes']} B "
            f"received in each step's gather of the sharded leaves (one "
            f"all_gather a step, no all-reduce at data = 1); peak device "
            f"memory in the steps {r['peak_tp']}"
            + (f", one process's step {r['peak_one']}" if rank == 0
               else "")
            + f"; launches {ran} (the autodiff route runs the code "
            f"tables' gradient kernel alone, one a table and step);"
            f" step s (host clock, a correctness run: two ranks share the "
            f"card) {[round(x, 4) for x in r['step_s']]}; "
            f"{r['replicated']} replicated leaves the same bits on both "
            f"ranks")
        _expect(ran, {"code_rows": 2 * steps} if device != "cpu" else {},
                f"17(c) rank {rank}")
    log(f"  17(c): srncar_fused.json with model = 2 raises: {r['refusal']}")


def mesh_path(work: str, device: str = "cuda", batch: int = R_TRAIN,
              H: int = 128, num_opts: int = 4) -> None:
    """Phase 17: data-parallel training and object-sharded fitting over a
    torch process mesh at ``srncar_fused.json`` widths, on phase 3's
    seeded training set and a 4-object test set; (a) world size 1 and the
    torchrun CLI, (b) two ranks sharing the card over gloo; (c) the model
    axis, ``(data=1, model=2)`` on two ranks sharing the card, on the
    autodiff route at ``srncar.json`` widths."""
    data = os.path.join(work, "data")
    write_dataset(data, "cars_train", 4, 4, H, seed=1)
    write_dataset(data, "cars_test", MESH_OBJS, 4, H)
    jsonfile = _config(work, "srncar_fused.json", check_points=2)
    t0 = time.perf_counter()
    mesh_nccl(work, jsonfile, device, batch, H, num_opts)
    mesh_cli(work, jsonfile, device, batch)
    log(f"phase 17(a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_gloo(work, jsonfile, device, batch, H, num_opts)
    log(f"phase 17(b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_tp(work, _config(work, "srncar.json", check_points=2), jsonfile,
            device, min(batch, TP_RAYS), H)
    log(f"phase 17(c): {time.perf_counter() - t0:.1f} s")


REPEAT_STEPS, REPEAT_CROP = 12, 6   # phase 18: steps, the crop phase's


def _repeat_routes(work: str, grid_size=None) -> list:
    """Phase 18's routes: (name, jsonfile, on a mesh, launches a step)."""
    fused = _config(work, "srncar_fused.json", out="repeat_fused.json")
    single = {"train": 1, "pack": 1, "code_rows": 2}
    return [
        ("(a) srncar_fused.json", fused, False, single),
        ("(b) srncar_hier_occ.json, phase 5's cuts",
         _hier_occ_config(work, grid_size, out="repeat_hier.json"), False,
         {"sigma": 1, "dual_train": 1, "pack": 1, "code_rows": 2}),
        ("(c) the separate fine network of phase 9",
         _hier_occ_config(work, grid_size, out="repeat_fine.json",
                          hierarchical_share_weights=False), False,
         {"planes": 2, "plane_train": 2, "pack": 2, "code_rows": 2}),
        ("(d) srncar.json (autodiff)",
         _config(work, "srncar.json", out="repeat_autodiff.json"), False,
         {"code_rows": 2}),
        ("(e) (a) on make_mesh(data=1)", fused, True, single)]


def _repeat_run(jsonfile: str, ds, device: str, batch: int, exps: str,
                name: str, mesh=None, steps: int = REPEAT_STEPS,
                crop: int = REPEAT_CROP):
    """A fresh ``Trainer`` of ``jsonfile`` 's seed trained ``steps`` steps
    across the crop→full switch at ``crop``: (every trainable, its AdamW
    moments and step count, in the optimizer's order, then the
    generator's state; the logged (step, loss, psnr, reg); the launch
    counts)."""
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.training.train_step import trainable_params
    from codenerf_tpu_torch.training.trainer import Trainer

    with LaunchCounts() as lc:
        tr = Trainer(name, load_hparams(jsonfile), batch_size=batch,
                     dataset=ds, exps_root=exps, check_iter=0, device=device,
                     mesh=mesh)
        tr.training(iters_crop=crop, iters_all=steps, log_every=1)
        counts = lc.get()
        if lc.plain_on_cuda:
            raise AssertionError(f"{lc.plain_on_cuda} plain-version calls "
                                 f"on CUDA tensors ({name})")
    opt = tr.state.optimizer
    leaves = []
    for p in trainable_params(tr.state):
        leaves.append(p.detach().clone())
        leaves += [opt.state[p][k].clone()
                   for k in ("exp_avg", "exp_avg_sq", "step")]
    leaves.append(tr.state.generator.get_state())
    logs = [(r["step"], r["loss/train"], r["psnr/train"], r["reg/train"])
            for r in _metrics(os.path.join(exps, name))
            if "loss/train" in r]
    return leaves, logs, counts


def repeat_path(work: str = None, device: str = "cuda", batch: int = R_TRAIN,
                H: int = 128, grid_size=None, diagnose: bool = False) -> None:
    """Phase 18: training repeats bit for bit. For each route of
    ``_repeat_routes`` two fresh trainers of one seed run ``REPEAT_STEPS``
    steps across the crop→full switch on phase 3's seeded ``cars_train``
    set (4 objects x 4 views); every parameter, both code tables, every
    AdamW moment and step count, the generator's state and every logged
    loss, PSNR and reg must be the same bits in both runs, and each run
    must launch each kernel its route runs as often as its steps say (on
    the card: ``code_rows`` two a step). Route (e) runs under
    ``make_mesh(data=1)`` at world size 1 (nccl on the card, gloo on the
    CPU). With ``diagnose``, each of (a)-(d) then runs 2 more steps under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` and the
    distinct warnings are printed; the mode is off again afterwards."""
    import warnings

    import torch
    import torch.distributed as dist

    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.parallel import mesh as pm

    own = work is None
    if own:
        scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build")
        os.makedirs(scratch, exist_ok=True)
        work = tempfile.mkdtemp(prefix="chip_smoke_repeat_", dir=scratch)
    try:
        data = os.path.join(work, "data")
        write_dataset(data, "cars_train", 4, 4, H, seed=1)
        ds = SRNDataset(cat="srn_cars", splits="cars_train", data_dir=data)
        exps = os.path.join(work, "exps_repeat")
        on_card = device != "cpu"
        routes = _repeat_routes(work, grid_size)
        for i, (what, jsonfile, meshed, per_step) in enumerate(routes):
            t0 = time.perf_counter()
            mesh = None
            if meshed:
                with _Env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0"):
                    pm.init_from_env(device,
                                     init_method=f"file://{work}/pg_repeat")
                mesh = pm.make_mesh(data=1)
            try:
                runs = [_repeat_run(jsonfile, ds, device, batch, exps,
                                    f"repeat{i}_{k}", mesh)
                        for k in range(2)]
            finally:
                if meshed:
                    dist.destroy_process_group()
            (la, ga, ca), (lb, gb, cb) = runs
            for counts in (ca, cb):
                _expect(counts, {k: v * REPEAT_STEPS * on_card
                                 for k, v in per_step.items()},
                        f"phase 18 {what}")
            same = [torch.equal(a, b) for a, b in zip(la, lb)]
            nbytes = sum(a.numel() * a.element_size() for a in la)
            ok = all(same) and len(la) == len(lb) and ga == gb \
                and len(ga) == REPEAT_STEPS
            log(f"phase 18 {what}: two trainings of {REPEAT_STEPS} steps "
                f"(crop until step {REPEAT_CROP}) from one seed: "
                f"{sum(same)} of {len(la)} leaves ({nbytes} B: parameters, "
                f"code tables, AdamW moments and steps, the generator) and "
                f"{len(ga)} logged losses "
                f"{'the same bits' if ok else 'NOT the same bits'}; loss by "
                f"step {[round(x[1], 6) for x in ga]}; launches a run "
                f"{ {k: v for k, v in ca.items() if v} }; "
                f"{time.perf_counter() - t0:.1f} s"
                f"{'' if ok else '  <-- FAILS'}")
            if not ok:
                raise AssertionError(f"phase 18 {what}: the trainings differ "
                                     f"({len(same) - sum(same)} leaves, "
                                     f"losses {ga != gb})")
        if diagnose:
            found = {}
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for i, (what, jsonfile, meshed, _) in enumerate(routes):
                    if meshed:
                        continue
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        _repeat_run(jsonfile, ds, device, batch, exps,
                                    f"diagnose{i}", steps=2, crop=1)
                    for w in caught:
                        if issubclass(w.category, ResourceWarning):
                            continue
                        key = str(w.message)[:240]
                        found.setdefault(key, []).append(what[:3])
            finally:
                torch.use_deterministic_algorithms(False)
            log(f"phase 18: under torch.use_deterministic_algorithms(True, "
                f"warn_only=True), {len(found)} distinct warnings:")
            for msg, where in found.items():
                log(f"  {sorted(set(where))}: {msg}")
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="stop after the kernel-vs-plain checks")
    ap.add_argument("--main_paths", action="store_true",
                    help="stop after the kernels line (phases 1-13 and 15)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from codenerf_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1: card {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    paths = _build.build_all(_build.all_sources())
    log(f"phase 1: built {len(paths)} kernel librar(ies) in "
        f"{time.perf_counter() - t0:.1f} s")
    for p in paths:
        for line in p.with_suffix(".log").read_text().splitlines():
            if any(k in line for k in ("registers", "spill", "Function",
                                       "wgmma", "setmaxnreg", "arning")):
                log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    log("phase 2: the trunk weights' packing vs its plain version")
    pack_check(dev)
    log("phase 2: the packed-operand cache across a fused AdamW update")
    staleness_check(dev)
    log(f"phase 2: kernel vs plain version at full width (W=256, 3+1 "
        f"blocks, S={S_FULL}); frozen-model mode at R={R_CODES}")
    entries = {"codes": kernel_check(dev, weight_grads=False)}
    log(f"phase 2: weight-gradient mode at R={R_TRAIN}")
    entries["train"] = kernel_check(dev, weight_grads=True)
    torch.cuda.empty_cache()
    log(f"phase 2: the weight-gradient kernel alone on the planes of a "
        f"training call at R={R_TRAIN}, S={S_FULL}")
    wgrad_check(dev)
    torch.cuda.empty_cache()
    log(f"phase 2: sigma-only forward at R={R_TRAIN} and R={R_CODES}, "
        f"S={S_COARSE}")
    entries["sigma"] = sigma_check(dev, R_TRAIN)
    small = sigma_check(dev, R_CODES)
    log(f"phase 2: sigma-only forward at R={R_TRAIN}, S={S_NERF_COARSE} "
        f"(NeRF's coarse pass of a 128x128 view)")
    nerf = sigma_check(dev, R_TRAIN, S_NERF_COARSE)
    entries["sigma"]["max_abs_err"] = max(entries["sigma"]["max_abs_err"],
                                          small["max_abs_err"],
                                          nerf["max_abs_err"])
    log(f"phase 2: dual mode, weight gradients at R={R_TRAIN}, S={S_UNION} "
        f"({S_COARSE} coarse + {S_UNION - S_COARSE} fine)")
    entries["dual_train"] = dual_check(dev, weight_grads=True)
    torch.cuda.empty_cache()
    log(f"phase 2: dual mode, frozen at R={R_CODES}, S={S_UNION}")
    entries["dual_codes"] = dual_check(dev, weight_grads=False)
    torch.cuda.empty_cache()
    log(f"phase 2: pose mode at R={R_POSE}, S={S_FULL}")
    entries["pose"] = pose_check(dev, S_FULL, want_weights=False)
    log(f"phase 2: pose mode with the weights plane at R={R_POSE}, "
        f"S={S_COARSE}")
    entries["pose_weights"] = pose_check(dev, S_COARSE, want_weights=True)
    log(f"phase 2: pose mode at R={R_POSE} on a {S_COARSE}+"
        f"{S_UNION - S_COARSE} union")
    union = pose_check(dev, S_UNION, want_weights=False, union=True)
    entries["pose"]["max_abs_err"] = max(entries["pose"]["max_abs_err"],
                                         union["max_abs_err"])
    for R, S in INPUT_CHAIN_SHAPES:
        log(f"phase 2: the input-chain kernel alone at R={R}, S={S}")
        row = input_chain_check(dev, R, S)
        if "input_chain" in entries:
            entries["input_chain"]["max_abs_err"] = max(
                entries["input_chain"]["max_abs_err"], row["max_abs_err"])
        else:
            entries["input_chain"] = row
    torch.cuda.empty_cache()
    log(f"phase 2: four-plane forward at R={R_TRAIN}, S={S_UNION}")
    entries["planes"] = planes_check(dev, R_TRAIN, S_UNION)
    torch.cuda.empty_cache()
    log(f"phase 2: four-plane forward at R={R_TRAIN}, S={S_FULL} (a "
        f"128x128 served or eval view's launch)")
    row = planes_check(dev, R_TRAIN, S_FULL)
    entries["planes"]["max_abs_err"] = max(entries["planes"]["max_abs_err"],
                                           row["max_abs_err"])
    torch.cuda.empty_cache()
    log(f"phase 2: four-plane forward at R={R_TRAIN}, S={S_NERF_UNION} (the "
        f"fine network of NeRF's {S_NERF_COARSE} + "
        f"{S_NERF_UNION - S_NERF_COARSE} render of a 128x128 view)")
    row = planes_check(dev, R_TRAIN, S_NERF_UNION)
    entries["planes"]["max_abs_err"] = max(entries["planes"]["max_abs_err"],
                                           row["max_abs_err"])
    torch.cuda.empty_cache()
    log(f"phase 2: the four-plane head alone on the t and r of a planes "
        f"call at R={R_TRAIN}, S={S_UNION}")
    entries["plane_head"] = plane_head_check(dev, R_TRAIN, S_UNION)
    for mode, R, S in (("plane_train", R_TRAIN, S_UNION),
                       ("plane_codes", R_CODES, S_UNION),
                       ("plane_pose", R_POSE, S_UNION),
                       ("plane_train_input", R_CODES, S_COARSE)):
        torch.cuda.empty_cache()
        log(f"phase 2: plane-op backward, {mode} at R={R}, S={S}")
        entries[mode] = plane_check(dev, mode, R, S)
    torch.cuda.empty_cache()
    log(f"phase 2: standalone composite at R={R_CODES}, S={S_FULL}")
    entries.update(composite_check(dev, R_CODES, S_FULL))
    log(f"phase 2: standalone composite at ragged shapes (R x S) "
        f"{COMPOSITE_RAGGED}")
    err = composite_ragged_check(dev)
    for key in ("composite", "composite_bwd"):
        entries[key]["max_abs_err"] = max(entries[key]["max_abs_err"], err)
    log(f"phase 2: chain identity, planes + composite + plane-op backward "
        f"vs the single-pass train mode at R={R_CODES}, S={S_UNION} and "
        f"pose mode at R={R_POSE}, S={S_UNION}")
    chain_check(dev, False, R_CODES, S_UNION)
    chain_check(dev, True, R_POSE, S_UNION)
    for mode, (kw, R, S) in PAIRS.items():
        torch.cuda.empty_cache()
        log(f"phase 2: the pair no path calls, {mode} ({kw}) at R={R}, "
            f"S={S}")
        entries[mode] = pair_check(dev, mode)
    torch.cuda.empty_cache()
    for R, S in SIGMA_HEAD_SHAPES:
        log(f"phase 2: the sigma-only head alone on the t of a sigma call "
            f"at R={R}, S={S}")
        row = sigma_head_check(dev, R, S)
        if "sigma_head" in entries:
            entries["sigma_head"]["max_abs_err"] = max(
                entries["sigma_head"]["max_abs_err"], row["max_abs_err"])
        else:
            entries["sigma_head"] = row
    torch.cuda.empty_cache()
    for R, S in FOLD_SHAPES:
        log(f"phase 2: the code cotangents' last pass alone at R={R}, "
            f"S={S}")
        row = fold_check(dev, R, S)
        entries.setdefault("ray_sum_fold", row)
    torch.cuda.empty_cache()
    log(f"phase 2: the code tables' gradient alone (code_row_sums) at "
        f"{D_CODES} columns, (objects, rays) "
        f"{[(n, R) for n, R, _ in CODE_ROW_CASES]}")
    entries["code_rows"] = code_rows_check(dev)
    torch.cuda.empty_cache()
    log("phase 2: the small kernels against their bounds")
    entries["pack"] = small_kernel_rates(dev)
    torch.cuda.empty_cache()
    log(f"phase 2: {time.perf_counter() - t0:.1f} s")
    if args.check:
        log("phase 2: done (--check)")
        return 0

    log("phases 3-4: coarse main path, python -m codenerf_tpu_torch.train "
        "then python -m codenerf_tpu_torch.optimize at srncar_fused.json "
        "widths")
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        launches = main_path(work)
        torch.cuda.empty_cache()
        log("phases 5-6: hierarchical main path, python -m "
            "codenerf_tpu_torch.train then python -m "
            "codenerf_tpu_torch.optimize --opt_occ true at "
            "srncar_hier_occ.json widths")
        _add(launches, hier_path(work))
        torch.cuda.empty_cache()
        log("phases 7-8: pose optimization, python -m "
            "codenerf_tpu_torch.pose_opt on the coarse and the hierarchical "
            "run")
        _add(launches, pose_paths(work))
        torch.cuda.empty_cache()
        log("phases 9-11: separate fine network, python -m "
            "codenerf_tpu_torch.train, .optimize --opt_occ true and "
            ".pose_opt at srncar_hier_occ.json widths with "
            "hierarchical_share_weights false")
        _add(launches, fine_paths(work))
        torch.cuda.empty_cache()
        log("phase 12: padded chunks, python -m codenerf_tpu_torch.optimize "
            "on the coarse run with 127x127 views")
        _add(launches, padded_path(work))
        torch.cuda.empty_cache()
        log("phase 15: the render service, export, editing, orbits and the "
            "bound radius on the coarse and the hierarchical run "
            "(codenerf_tpu_torch.serving, .export_reference_checkpoint, "
            ".edit, .render_orbit, .estimate_bound_radius)")
        t0 = time.perf_counter()
        service_path(work)
        log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    # The kernels checked alone run inside the modes' launches: one
    # input_chain_kernel in each launch of an input-gradient mode, one
    # plane_head_kernel in each planes launch, one sigma_head_kernel in
    # each sigma launch, one ray_sum_fold_kernel in each fused_step launch
    # (the step profiles count them by name).
    def total(modes):
        return sum(launches.get(m, 0) for m in modes)

    for kernel, modes in (("input_chain", INPUT_MODES),
                          ("plane_head", ("planes",)),
                          ("sigma_head", ("sigma",))):
        launches[kernel] = total(modes)
        MAIN_POINTS[kernel] = sum(MAIN_POINTS.get(m, 0) for m in modes)
    # Every CUDA kernel's launches on the main paths, from the modes'
    # counts: each fused_step launch converts its cotangent sums once;
    # pack_kernel has its own counter (one launch per weight version).
    steps = total(STEP_MODES)
    MAIN_POINTS["pack"] = launches["pack"]
    launches["ray_sum_fold"] = steps
    by_kernel = {
        "trunk_fwd_kernel": steps + total(("sigma", "planes")),
        "trunk_dx_kernel": steps, "head_kernel": steps,
        "wgrad_kernel": total(WEIGHT_MODES),
        "fixed_sum_kernel": total(WEIGHT_MODES),
        "pack_kernel": launches["pack"],
        "ray_sum_fold_kernel": steps,
        "sigma_head_kernel": launches["sigma_head"],
        "plane_head_kernel": launches["plane_head"],
        "input_chain_kernel": launches["input_chain"],
        "composite_kernel": launches.get("composite", 0)
        + launches.get("composite_bwd", 0),
        "code_row_tiles_kernel": launches.get("code_rows", 0),
        "code_row_fold_kernel": launches.get("code_rows", 0)}
    log("CUDA kernel launches on the main paths (phases 3-12): " + ", ".join(
        f"{k} {v}" for k, v in by_kernel.items()))
    # Every trunk forward stores t at least, by TMA from the tile.
    ran = {m: launches[m] for m in MAIN_BULK if launches.get(m, 0)}
    log("planes stored by TMA from trunk_fwd_kernel's tile on the main "
        "paths (bulk_planes; launches): " + ", ".join(
            f"{m} {MAIN_BULK[m]} ({n})" for m, n in ran.items()))
    silent = [m for m in ran if not MAIN_BULK[m]]
    if silent:
        raise AssertionError(f"no plane stored by TMA in modes {silent}")
    rows, excess = [], []
    for mode in ("codes", "train", "sigma", "dual_train", "dual_codes",
                 "pose", "pose_weights", "planes", "plane_train",
                 "plane_codes", "plane_pose", "plane_train_input",
                 "composite", "composite_bwd", "train_input",
                 "train_weights", "input_chain", "plane_head", "sigma_head",
                 "ray_sum_fold", "pack", "code_rows"):
        # plane_train_input, train_input and train_weights have no caller
        # on a main path
        e = entries[mode]
        e["launches"] = launches.get(mode, 0)
        rows.append({k: e[k] for k in keys})
        excess.append((MAIN_POINTS.get(mode, 0) / PHASE2_POINTS[mode]
                       * (e["ms"] - e["bound_ms"]), mode))
    # The order of the next work: the device ms above the bound that the
    # main paths' launches spent, each launch priced at its own shape.
    log("sum over launches of (ms - bound_ms) x launch points / phase-2 "
        "points (each launch priced at the shape it ran): " + ", ".join(
            f"{mode} {v:.1f}" for v, mode in sorted(excess, reverse=True)))
    print(json.dumps({"kernels": rows}))
    if args.main_paths:
        log("phases 1-13 and 15: done (--main_paths)")
        return 0
    log(f"phase 14: quality, cut: python -m codenerf_tpu_torch.quality_report"
        f" --use_fused --samples 96 --seeds 0 at {QUALITY_STEPS} steps, then "
        "--resume_train sequentially, with --opt_group 4 and with "
        "--opt_rays 1024")
    t0 = time.perf_counter()
    _reset_peak("cuda")
    work = tempfile.mkdtemp(prefix="chip_smoke_quality_", dir=scratch)
    try:
        quality_path(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{_peak('cuda')}")
    log(f"phase 16: the device scenes at full scale (synthetic_scene "
        f"backend='device', {FULL_SPLIT}), then the native ray sampler")
    t0 = time.perf_counter()
    scene_path()
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    log("phase 17: multi-GPU, the process mesh at srncar_fused.json "
        "widths: (a) nccl at world size 1 and torchrun --nproc_per_node 1 "
        "train --data_axis 1, (b) two gloo ranks sharing the card; (c) "
        f"tensor parallelism, (data=1, model=2) on two gloo ranks sharing "
        f"the card at srncar.json widths, {MESH_STEPS} steps of {TP_RAYS} "
        f"rays")
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=scratch)
    try:
        mesh_path(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 18: training repeats: two trainings of one seed a route, "
        f"{REPEAT_STEPS} steps of {R_TRAIN} rays across the crop->full "
        f"switch, (a)-(e) at full width")
    t0 = time.perf_counter()
    repeat_path()
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
