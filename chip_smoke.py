#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codenerf_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --check    # build + kernel-vs-plain check only

Phases, each printed on its own line:

1. the card (``nvidia-smi`` name and power limit); build every CUDA kernel
   from ``codenerf_tpu_torch/ops/csrc`` (one ``nvcc`` per source, started
   together);
2. each kernel against its plain PyTorch version at the main path's full
   width (R=4096 rays, S=96 samples, W=256, 3 shape + 1 texture blocks,
   seeded inputs), with the tolerance stated in ``_close``; timings of the
   kernel, the plain version and the bound;
3. the main path: a seeded SRN-layout set (2 objects x 4 views, 128x128)
   and a full-width ``models.pth`` from the port's seeded init go through
   ``codenerf_tpu_torch.optimize.main`` at ``jsonfiles/srncar_fused.json``
   widths; the kernel's launch count must equal steps x chunks x objects
   and ``results.json`` must be finite;
4. the ``kernels`` JSON line, the card line, and the last line
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
R_FULL, S_FULL = 4096, 96


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _close(name, got, want):
    """Kernel vs plain version. Both round to bf16 at the same points, so
    they differ by f32 summation order, which flips an occasional bf16
    rounding. The bar: relative L2 error below 5e-3 (the bar of
    tests/test_torch_fused_train.py, where JAX and the plain version
    measure 1.3e-3 to 2.4e-3); every element within 5e-2 of the output's
    largest magnitude; and fewer than 1e-3 of the elements outside the
    test's elementwise bar of 1e-2 of the largest magnitude plus 5e-3
    relative — at 3.1M elements per cotangent a few per-ray sums that
    nearly cancel keep the absolute error of their terms. Returns the max
    abs error."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (got - want).abs()
    top = float(want.abs().max())
    rel_l2 = float(torch.linalg.vector_norm(got - want)
                   / torch.linalg.vector_norm(want).clamp_min(1e-30))
    outside = float((err > 1e-2 * top + 5e-3 * want.abs()).float().mean())
    log(f"  {name}: max_abs_err {float(err.max()):.3e} (max |want| "
        f"{top:.3e}) rel_l2 {rel_l2:.3e}, share outside the elementwise "
        f"bar {outside:.2e}")
    if rel_l2 >= 5e-3 or float(err.max()) > 5e-2 * top or outside >= 1e-3:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return float(err.max())


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


def kernel_check(dev):
    """Phase 2: train_fused (CUDA) vs train_fused_plain at full width."""
    import torch

    from codenerf_tpu_torch.config import NetConfig
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.ops import fused_mlp, fused_train

    cfg = NetConfig()                      # srncar_fused.json widths
    R, S = R_FULL, S_FULL
    gen = torch.Generator(device=dev).manual_seed(1)
    model = CodeNeRF(cfg, generator=gen, device=dev).requires_grad_(False)
    ro = torch.rand(R, 3, generator=gen, device=dev) * 0.6 - 0.3
    ro = ro + torch.tensor([0.0, 0.0, 1.3], device=dev)
    vd = torch.randn(R, 3, generator=gen, device=dev)
    vd = vd / vd.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.rand(R, S, generator=gen, device=dev), -1).values
    z = 0.8 + z
    sc = torch.randn(cfg.latent_dim, generator=gen, device=dev) * 0.1
    tc = torch.randn(cfg.latent_dim, generator=gen, device=dev) * 0.1
    gt = torch.rand(R, 3, generator=gen, device=dev)
    ro8, vd8, z, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
        model, cfg, ro, vd, z, sc, tc)
    gt8 = fused_mlp.pad_lanes(gt, 8)
    wops = fused_train.kernel_operands(fused_train.flatten_params(model, cfg))
    scale = 1.0 / (R * 3.0)
    args = (cfg, S, R, True, scale, ro8, vd8, z, sproj, tproj, vcontrib,
            gt8, wops)

    got = fused_train.train_fused(*args, want_rgb=True, weight_grads=False)
    torch.cuda.synchronize()
    want = fused_train.train_fused_plain(*args, want_rgb=True)
    torch.cuda.synchronize()
    errs = [_close("se_sum", got[0].reshape(1), want[0].reshape(1))]
    for name, g, w in zip(["d_sproj", "d_tproj", "d_vcontrib", "rgb8"],
                          got[1:], want[1:]):
        errs.append(_close(name, g, w))

    ms = time_cuda(lambda: fused_train.train_fused(
        *args, want_rgb=True, weight_grads=False), reps=10)
    plain_ms = time_cuda(lambda: fused_train.train_fused_plain(
        *args, want_rgb=True), reps=3)

    W, nb, nt = cfg.W, cfg.shape_blocks, cfg.texture_blocks
    P = R * S
    flops = (2 * P * (64 * W + W * W * (nb + nt + 2) + W * W // 2)
             + 2 * P * (W * W * (nb + nt + 2) + W * W // 2))
    in_bytes = (R * 8 * 4 * 3 + R * S * 4 + R * (nb + nt + 1) * W * 2
                + sum(w.numel() * w.element_size() for w in wops))
    out_bytes = R * 8 * 4 * 2 + R * (nb + nt + 1) * W * 2
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    log(f"  kernel {ms:.4f} ms/chunk, plain {plain_ms:.4f} ms/chunk, bound "
        f"{max(t_ops, t_bytes):.4f} ms ({flops:.4e} FLOP -> {t_ops:.4f} ms; "
        f"{in_bytes + out_bytes} B -> {t_bytes:.4f} ms)")
    profile_breakdown(lambda: fused_train.train_fused(
        *args, want_rgb=True, weight_grads=False))
    return {
        "name": "train_fused (weight_grads=False, want_rgb)",
        "route": "cuda",
        "source": "codenerf_tpu_torch/ops/csrc/train_fused_codes.cu",
        "replaces": "codenerf_tpu/ops/fused_train.py:447",
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def profile_breakdown(fn) -> None:
    """Device time per CUDA kernel name over three calls (torch.profiler);
    prints 'not measured' when the trace carries no device time."""
    import torch
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
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f"  profile: {ms:.4f} ms/call in {n} launch(es) of {key[:90]}")


def profile_steps(hp, run_dir: str, data_dir: str, device: str,
                  steps: int = 3) -> None:
    """Where a step's time goes: ``steps`` optimization steps of the first
    object under torch.profiler, after one warm-up step. Prints wall ms per
    step, device-busy ms per step split into this port's kernels and the
    PyTorch kernels around them, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer
    from codenerf_tpu_torch.utils.checkpoint import load_reference_checkpoint

    state, sc, tc = load_reference_checkpoint(os.path.join(run_dir,
                                                           "models.pth"))
    model = CodeNeRF(hp.net)
    model.load_state_dict(state)
    opt = CodeOptimizer(model, hp, mean_code(sc), mean_code(tc),
                        device=device)
    ds = SRNDataset(splits="cars_test", data_dir=data_dir, max_objects=1)
    gen = torch.Generator(device=device).manual_seed(0)
    args = (ds.images[0], ds.poses[0], float(ds.focals[0]), [0], gen)
    opt.optimize_object(*args, num_opts=1, progress_images=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.optimize_object(*args, num_opts=steps, progress_images=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ours = other = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        if ev.name.startswith(("void (anonymous namespace)::",
                               "(anonymous namespace)::")):
            ours += us
        else:
            other += us
    ours, other = ours / 1e3 / steps, other / 1e3 / steps
    log(f"  step profile: {wall_ms:.3f} ms wall per step; device busy "
        f"{ours + other:.3f} ms (port kernels {ours:.3f}, PyTorch kernels "
        f"{other:.3f}); device idle share "
        f"{max(0.0, 1.0 - (ours + other) / wall_ms):.3f}")


def write_dataset(root: str, n_objs: int = 2, n_views: int = 4,
                  H: int = 128, seed: int = 0) -> None:
    """Seeded SRN-layout split ``srn_cars/cars_test``: poses on a sphere of
    radius 1.3 looking at the origin (the SRN-cars camera distance), images
    a shaded disk of a random albedo on white."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    focal = 131.25                         # SRN cars at 128 px
    yy, xx = np.mgrid[0:H, 0:H].astype(np.float32)
    rr = np.sqrt((xx - H / 2) ** 2 + (yy - H / 2) ** 2) / (H * 0.3)
    for oi in range(n_objs):
        obj = os.path.join(root, "srn_cars", "cars_test", f"obj{oi:04d}")
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


def main_path(work: str, device: str = "cuda", H: int = 128,
              n_objs: int = 2, n_views: int = 4, num_opts: int = 5) -> dict:
    """Phase 3: the port's optimize CLI at srncar_fused.json widths."""
    import numpy as np
    import torch

    from codenerf_tpu_torch import optimize
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.models.codes import init_codes
    from codenerf_tpu_torch.ops import fused_train
    from codenerf_tpu_torch.renderer import chunk_plan
    from codenerf_tpu_torch.utils.checkpoint import save_reference_checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jsonfiles", "srncar_fused.json")) as f:
        cfg_json = json.load(f)
    data_dir = os.path.join(work, "data")
    cfg_json["data"]["data_dir"] = data_dir
    jsonfile = os.path.join(work, "srncar_fused.json")
    with open(jsonfile, "w") as f:
        json.dump(cfg_json, f)
    hp = load_hparams(jsonfile)
    write_dataset(data_dir, n_objs, n_views, H)
    gen = torch.Generator().manual_seed(0)
    model = CodeNeRF(hp.net, generator=gen)
    run_dir = os.path.join(work, "exps", "smoke")
    os.makedirs(run_dir)
    save_reference_checkpoint(
        os.path.join(run_dir, "models.pth"), model,
        init_codes(16, hp.net.latent_dim, gen),
        init_codes(16, hp.net.latent_dim, gen))

    fused_train.train_fused.launches = 0
    out = optimize.main([
        "--jsonfile", jsonfile, "--exps_root", os.path.join(work, "exps"),
        "--saved_dir", "smoke", "--num_opts", str(num_opts),
        "--tgt_instances", "0", "--device", device])
    launches = fused_train.train_fused.launches

    _, chunks, _ = chunk_plan(H * H, 4096)
    expect = num_opts * chunks * n_objs
    log(f"  main path: train_fused launches {launches} (expected "
        f"{num_opts} steps x {chunks} chunks x {n_objs} objects = {expect})")
    if launches != expect:
        raise AssertionError("kernel launch count off on the main path")
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
    profile_steps(hp, run_dir, data_dir, device)
    t = out["timing"]
    log(f"  main path: psnr_history {[round(v, 3) for v in hist]}")
    log(f"  main path: mean eval psnr {res['mean_psnr']:.4f} ssim "
        f"{res['mean_ssim']:.4f}")
    log(f"  main path: {1e3 * t['opt_s'] / t['opt_steps']:.3f} ms per opt "
        f"step ({chunks} chunk(s) of {H * H // chunks} rays, host clock incl. "
        f"first-object warm-up), {1e3 * t['eval_s'] / t['eval_views']:.3f} "
        f"ms per eval view ({H}x{H})")
    return {"launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="stop after the kernel-vs-plain check")
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
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    log("phase 2: kernel vs plain version at full width (R=4096, S=96, "
        "W=256, 3+1 blocks)")
    entry = kernel_check(dev)
    if args.check:
        log("phase 2: done (--check)")
        return 0

    log("phase 3: main path, python -m codenerf_tpu_torch.optimize at "
        "srncar_fused.json widths")
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        mp = main_path(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    entry["launches"] = mp["launches"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: entry[k] for k in keys}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
