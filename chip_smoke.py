#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codenerf_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --check    # build + kernel-vs-plain checks only

Phases, each printed on its own line:

1. the card (``nvidia-smi`` name and power limit); build every CUDA kernel
   from ``codenerf_tpu_torch/ops/csrc`` (one ``nvcc`` per source, started
   together);
2. each kernel mode against its plain PyTorch version at the main path's
   full width (W=256, 3 shape + 1 texture blocks, S=96 samples, seeded
   inputs), with the tolerance stated in ``_close``: the frozen-model mode
   at the optimization chunk (R=4096) and the weight-gradient mode at the
   training batch (R=16,384), whose per-ray cotangents must also equal
   the frozen mode's on the same inputs; timings of each kernel, its
   plain version and its bound, and a ``torch.profiler`` breakdown by
   kernel name (for the weight-gradient mode also each launch of one
   call in order, and the frozen mode's profile on the same inputs);
3. training: ``codenerf_tpu_torch.train.main`` at
   ``jsonfiles/srncar_fused.json`` widths and the CLI's batch of 16,384
   rays on a seeded SRN-layout ``cars_train`` set (4 objects x 4 views,
   128x128): 10 steps crossing the crop->full switch at step 5, with a
   checkpoint at mid-run (step 5) and at the end; then a second run
   resumes (``--resume``) from a copy of the mid-run checkpoint and runs
   the last 5 steps again. Each run's launch count of the weight-gradient
   kernel must equal its steps, every logged loss must be finite, and the
   resumed run must end at the uninterrupted run's loss. Then the step
   profile (wall ms untraced and under the profiler, device-busy ms split
   into the port's kernels and PyTorch's, idle share, the largest kernels
   by name);
4. test-time optimization: ``codenerf_tpu_torch.optimize.main`` reads the
   training run's ``ckpt/`` and fits codes for a seeded ``cars_test`` set
   (2 objects x 4 views); the frozen-model kernel's launch count must
   equal steps x chunks x objects and ``results.json`` must be finite;
   then that step's profile;
5. the ``kernels`` JSON line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
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
SOURCE = "codenerf_tpu_torch/ops/csrc/train_fused.cu"
REPLACES = "codenerf_tpu/ops/fused_train.py:447"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _close(name, got, want, terms=None, per_ray=False):
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
    the relative L2 test is dropped. Returns (max abs error, passed)."""
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
        ray_err = float((torch.linalg.vector_norm(g2 - w2, dim=1)
                         / norms.clamp_min(1e-2 * float(norms.max()))).max())
        guard += f", worst ray's relative L2 {ray_err:.2e}"
        guard_ok = ray_err < 0.25
    else:
        guard_ok = elem <= 5e-2
    ok = (bool(torch.isfinite(got).all())
          and (terms is not None or rel_l2 < 5e-3)
          and guard_ok and outside < 1e-3)
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
    """Seeded full-width operands of one kernel call."""
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
    wops = fused_train.kernel_operands(fused_train.flatten_params(model, cfg))
    return cfg, (cfg, S, R, True, 1.0 / (R * 3.0), ro8, vd8, z, sproj, tproj,
                 vcontrib, fused_mlp.pad_lanes(gt, 8), wops)


def bound(cfg, R: int, S: int, wops, weight_grads: bool):
    """(bound ms, bound_by, FLOP, bytes): matmul operations at the dense
    bf16 peak against the bytes the function must move (inputs read once,
    outputs written once) at the HBM rate."""
    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    P = R * S
    fwd = 2 * P * (64 * W + W * W * (nb + nt + 2) + W * W // 2)
    dx = 2 * P * (W * W * (nb + nt + 2) + W * W // 2)
    flops = fwd + dx + (fwd if weight_grads else 0)
    w_bytes = sum(w.numel() * w.element_size() for w in wops)
    in_bytes = R * 8 * 4 * 3 + R * S * 4 + R * (nb + nt + 1) * W * 2 + w_bytes
    out_bytes = R * 8 * 4 + R * (nb + nt + 1) * W * 2
    if weight_grads:
        out_bytes += 4 * sum(w.numel() for w in wops)
    else:
        out_bytes += R * 8 * 4                     # rgb8
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, in_bytes + out_bytes)


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
    if weight_grads:
        # The per-ray cotangents come from the same dx chain in both
        # modes: on the same inputs the frozen mode must give them to
        # within the order of the f32 atomic ray sums, which can flip the
        # final bf16 rounding (bar: 1e-2 of the largest magnitude).
        frozen = fused_train.train_fused(*args, weight_grads=False)
        for name, a, b in zip(["se_sum", "d_sproj", "d_tproj",
                               "d_vcontrib"], got[:4], frozen):
            d = float((a.float() - b.float()).abs().max())
            ok = d <= 1e-2 * float(b.float().abs().max())
            log(f"  {name}: weight-gradient vs frozen mode, max abs "
                f"difference {d:.3e}{'' if ok else '  <-- FAILS'}")
            checks.append((f"{name} (vs frozen mode)", d, ok))
        del frozen
    del got, want
    failed = [name for name, _, ok in checks if not ok]
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version on "
                             f"{failed}")
    errs = [e for name, e, _ in checks if "frozen" not in name]

    ms = time_cuda(lambda: fused_train.train_fused(*args, **kw), reps=10)
    plain_ms = time_cuda(lambda: fused_train.train_fused_plain(*args, **kw),
                         reps=3)
    bound_ms, bound_by, flops, nbytes = bound(cfg, R, S, args[-1],
                                              weight_grads)
    log(f"  kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound "
        f"{bound_ms:.4f} ms ({flops:.4e} FLOP at {PEAK_BF16_FLOPS:.3e}/s; "
        f"{nbytes} B at {PEAK_HBM_BYTES:.3e} B/s) at R={R}, S={S}")
    profile_breakdown(lambda: fused_train.train_fused(*args, **kw),
                      sequence=weight_grads)
    if weight_grads:
        # The weight-gradient mode stores the PE once (pe_kernel) and
        # reads it in the enc_xyz forward and dW GEMMs; the frozen mode
        # builds it inside the enc_xyz GEMM's A-tile loads. Its profile
        # on the same inputs prices that recomputation.
        log(f"  frozen mode on the same inputs (R={R}), for the cost of "
            f"building the PE in the GEMM's loads:")
        profile_breakdown(lambda: fused_train.train_fused(
            *args, weight_grads=False))
    mode = ("weight_grads=True" if weight_grads
            else "weight_grads=False, want_rgb")
    return {"name": f"train_fused ({mode})", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
PORT_KERNELS = ("gemm_kernel", "dw_kernel", "head_kernel", "pe_kernel",
                "colsum_kernel", "f32_to_bf16_kernel")


def log_step_profile(what: str, untraced_ms: float, wall_ms: float, prof,
                     steps: int) -> None:
    """Wall ms per step untraced and traced, device-busy ms in the traced
    window split into the port's kernels and PyTorch's, the idle share
    against each wall, and the device ms per step of the largest kernels
    by name (port or PyTorch). The tracer spaces kernels apart and slows
    the host, so the idle share against the untraced wall is the step's
    own."""
    from torch.autograd import DeviceType

    ours, other, by_name = 0.0, 0.0, {}
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
        + ", ".join(f"{k} {v:.3f}" for k, v in top))


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


def _losses(run_dir: str):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss/train"]) for r in map(json.loads, f)
                if "loss/train" in r]


def train_path(work: str, jsonfile: str, device: str = "cuda",
               batch: int = R_TRAIN, H: int = 128, iters_crop: int = 5,
               iters_all: int = 10) -> dict:
    """Phase 3: the port's train CLI, then a resumed run from the mid-run
    checkpoint. Returns the weight-gradient kernel's launch count."""
    import numpy as np
    import torch

    from codenerf_tpu_torch import train
    from codenerf_tpu_torch.ops import fused_train

    write_dataset(os.path.join(work, "data"), "cars_train", 4, 4, H, seed=1)
    exps = os.path.join(work, "exps")
    base = ["--jsonfile", jsonfile, "--exps_root", exps, "--batchsize",
            str(batch), "--iters_crop", str(iters_crop), "--check_iter", "0",
            "--log_every", "1", "--device", device]
    on_card = device != "cpu"       # the counters count CUDA launches only
    counts = fused_train.train_fused.launches
    for mode in counts:
        counts[mode] = 0
    t0 = time.perf_counter()
    train.main(base + ["--save_dir", "smoke", "--iters_all",
                       str(iters_all), "--resume", "false"])
    wall = time.perf_counter() - t0
    launches = counts["train"]
    run_dir = os.path.join(exps, "smoke")
    losses = _losses(run_dir)
    log(f"  train: {launches} launches of the weight-gradient kernel "
        f"(expected {iters_all} steps), {wall:.2f} s host clock incl. "
        f"set-up; loss by step {[(s, round(v, 6)) for s, v in losses]}")
    if launches != (iters_all if on_card else 0):
        raise AssertionError("kernel launch count off on the training path")
    if len(losses) != iters_all or not np.isfinite([v for _, v in
                                                    losses]).all():
        raise AssertionError("training losses missing or not finite")
    ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    mid = f"step_{iters_crop:08d}.pt"
    if mid not in ckpts or f"step_{iters_all:08d}.pt" not in ckpts:
        raise AssertionError(f"checkpoints missing: {ckpts}")

    # Resume from a copy of the mid-run checkpoint.
    os.makedirs(os.path.join(exps, "resumed", "ckpt"))
    shutil.copy(os.path.join(run_dir, "ckpt", mid),
                os.path.join(exps, "resumed", "ckpt", mid))
    train.main(base + ["--save_dir", "resumed", "--iters_all",
                       str(iters_all), "--resume", "true"])
    total, other = counts["train"], counts["codes"]
    resumed = total - launches
    losses_r = _losses(os.path.join(exps, "resumed"))
    log(f"  resume: {resumed} launches (expected {iters_all - iters_crop}); "
        f"loss by step {[(s, round(v, 6)) for s, v in losses_r]}")
    if resumed != (iters_all - iters_crop if on_card else 0) or other:
        raise AssertionError("kernel launch count off on the resumed run")
    # The uninterrupted and the resumed run see the same batches and
    # depths; on the card the f32 atomic ray sums may change last bits.
    last, last_r = losses[-1], losses_r[-1]
    if last_r[0] != last[0] or not abs(last_r[1] - last[1]) <= \
            1e-3 * abs(last[1]):
        raise AssertionError(f"resumed run ends at {last_r}, the "
                             f"uninterrupted one at {last}")
    if on_card:
        profile_training(jsonfile, run_dir, device, batch)
    return {"launches": total, "run": "smoke"}


def profile_training(jsonfile: str, run_dir: str, device: str,
                     batch: int, steps: int = 10) -> None:
    """The training step's profile, resumed from the run's checkpoint."""
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.training.trainer import Trainer

    hp = load_hparams(jsonfile)
    tr = Trainer("profile", hp, batch_size=batch,
                 exps_root=os.path.dirname(run_dir), check_iter=0,
                 device=device)
    tr.ckpt_dir = os.path.join(run_dir, "ckpt")
    tr.resume()
    out = tr.profile_steps(steps, trace_dir=os.path.join(
        os.path.dirname(run_dir), "profile"))
    log_step_profile("train", out["untraced_ms"], out["wall_ms"],
                     out["profile"], steps)


def optimize_path(work: str, jsonfile: str, run: str, device: str = "cuda",
                  H: int = 128, n_objs: int = 2, n_views: int = 4,
                  num_opts: int = 5) -> dict:
    """Phase 4: the port's optimize CLI on the training run's ``ckpt/``."""
    import numpy as np
    import torch

    from codenerf_tpu_torch import optimize
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.ops import fused_train
    from codenerf_tpu_torch.renderer import chunk_plan

    hp = load_hparams(jsonfile)
    data_dir = os.path.join(work, "data")
    write_dataset(data_dir, "cars_test", n_objs, n_views, H)
    exps = os.path.join(work, "exps")
    if os.path.exists(os.path.join(exps, run, "models.pth")):
        raise AssertionError("the run must be read from its ckpt/")
    counts = fused_train.train_fused.launches
    for mode in counts:
        counts[mode] = 0
    out = optimize.main([
        "--jsonfile", jsonfile, "--exps_root", exps, "--saved_dir", run,
        "--num_opts", str(num_opts), "--tgt_instances", "0", "--device",
        device])
    launches, other = counts["codes"], counts["train"]
    _, chunks, _ = chunk_plan(H * H, 4096)
    expect = num_opts * chunks * n_objs
    log(f"  optimize: {launches} launches of the frozen-model kernel "
        f"(expected {num_opts} steps x {chunks} chunks x {n_objs} objects "
        f"= {expect})")
    if launches != (expect if device != "cpu" else 0) or other:
        raise AssertionError("kernel launch count off on the optimize path")
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
        f"step ({chunks} chunk(s) of {H * H // chunks} rays, host clock "
        f"incl. first-object warm-up), "
        f"{1e3 * t['eval_s'] / t['eval_views']:.3f} ms per eval view "
        f"({H}x{H})")
    if device != "cpu":
        profile_optimize(hp, os.path.join(exps, run), data_dir, device)
    return {"launches": launches}


def profile_optimize(hp, run_dir: str, data_dir: str, device: str,
                     steps: int = 10) -> None:
    """Where an optimization step's time goes: ``steps`` steps of the first
    object untraced, then ``steps`` more under torch.profiler, after one
    warm-up step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer
    from codenerf_tpu_torch.utils.checkpoint import load_training_checkpoint

    state, sc, tc = load_training_checkpoint(os.path.join(run_dir, "ckpt"))
    model = CodeNeRF(hp.net)
    model.load_state_dict(state)
    opt = CodeOptimizer(model, hp, mean_code(sc), mean_code(tc),
                        device=device)
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
    log_step_profile("optimize", untraced_ms, wall_ms, prof, steps)


def main_path(work: str, device: str = "cuda", batch: int = R_TRAIN,
              H: int = 128, num_opts: int = 5) -> dict:
    """Phases 3 and 4 at ``srncar_fused.json`` widths (check_points cut to
    the mid-run step). ``device="cpu"`` with a small ``batch`` and ``H``
    rehearses them through the plain versions (the launch counts stay 0
    there: they count CUDA launches only)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jsonfiles", "srncar_fused.json")) as f:
        cfg_json = json.load(f)
    cfg_json["data"]["data_dir"] = os.path.join(work, "data")
    cfg_json["check_points"] = 5
    jsonfile = os.path.join(work, "srncar_fused.json")
    with open(jsonfile, "w") as f:
        json.dump(cfg_json, f)
    tp = train_path(work, jsonfile, device, batch, H)
    op = optimize_path(work, jsonfile, tp["run"], device, H,
                       num_opts=num_opts)
    return {"train": tp["launches"], "codes": op["launches"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="stop after the kernel-vs-plain checks")
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
            if "registers" in line or "spill" in line or "Function" in line:
                log(f"  ptxas: {line.strip()}")

    log(f"phase 2: kernel vs plain version at full width (W=256, 3+1 "
        f"blocks, S={S_FULL}); frozen-model mode at R={R_CODES}")
    entries = {"codes": kernel_check(dev, weight_grads=False)}
    log(f"phase 2: weight-gradient mode at R={R_TRAIN}")
    entries["train"] = kernel_check(dev, weight_grads=True)
    torch.cuda.empty_cache()
    if args.check:
        log("phase 2: done (--check)")
        return 0

    log("phases 3-4: main path, python -m codenerf_tpu_torch.train then "
        "python -m codenerf_tpu_torch.optimize at srncar_fused.json widths")
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        launches = main_path(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    rows = []
    for mode in ("codes", "train"):
        entries[mode]["launches"] = launches[mode]
        rows.append({k: entries[mode][k] for k in keys})
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
