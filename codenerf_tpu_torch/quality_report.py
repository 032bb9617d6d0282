"""End-to-end quality report on synthetic scenes, the port's twin of
``tools/quality_report.py``:

    python -m codenerf_tpu_torch.quality_report --use_fused --samples 96 \\
        --seeds 0,1,2 [--device cuda] [--out exps/codenerf_quality]

The whole reference workflow (SURVEY §6's protocol on synthetic scenes):

1. train a category model on ``--n_train_objects`` synthetic objects
   (the flagship widths: W=256, 3+1 blocks, latent 256, 10/4 frequencies;
   8192 rays a step, ``--steps`` steps, the first sixth on the center
   crop);
2. for each held-out object: start the codes at the training mean, fit
   them on the ``--tgt_views`` view(s) (``--num_opts`` AdamW steps, lr
   1e-2 halved every 50), then score PSNR/SSIM on every other view;
3. write ``RESULTS.md`` (and with several seeds ``SUMMARY.md``, mean ±
   std across seeds) in the JAX tool's layout, and print
   ``{"psnr_by_seed": [...]}`` last.

The scenes are the port's copy of the JAX package's numpy scenes
(``data/synthetic.py``), bit-equal for a seed: scene seed ``11 + 100 ·
seed`` (and ``+ 57`` for the held-out draw of the ``--n_test_views``
protocol), so each seed trains on the images the JAX tool trains on.
Training draws from the trainer's own seeded streams (``hp.seed =
seed``); fitting and eval draw from ``torch.Generator``s seeded from a
master generator of the seed, two per object in object order, whatever
``--opt_group`` is, so the per-object results are comparable across
settings. The flags and defaults are the JAX tool's, with ``--device``
(``cuda``, the default, or ``cpu``) added and the output under
``exps/`` by default. ``--scene_backend device`` (the JAX tool's
``jax``) renders the scenes on the device, for the full-scale splits;
``--device_gt`` (with ``--opt_group`` > 1) renders each eval view's
ground truth on the device from the test scene's generation parameters
instead of copying its pixels there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="CodeNeRF quality report on synthetic scenes (PyTorch)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--num_opts", type=int, default=200)
    ap.add_argument("--n_train_objects", type=int, default=16)
    ap.add_argument("--n_test_objects", type=int, default=4)
    ap.add_argument("--n_views", type=int, default=24)
    ap.add_argument("--n_test_views", type=int, default=None,
                    help="views per test object (default: --n_views, one "
                         "category draw sliced into train and held-out); "
                         "otherwise the test objects are a separate draw")
    ap.add_argument("--cam_distance", type=float, default=4.0)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--n_importance", type=int, default=0)
    ap.add_argument("--out", type=str,
                    default=os.path.join("exps", "codenerf_quality"))
    ap.add_argument("--seeds", type=str, default="0",
                    help="comma-separated seeds; each reruns the whole "
                         "pipeline (category draw + training RNG)")
    ap.add_argument("--use_fused", action="store_true",
                    help="the single-pass fused kernels for training and "
                         "code fitting")
    ap.add_argument("--bound_radius", type=float, default=None)
    ap.add_argument("--occ", action="store_true",
                    help="training-time occupancy grid (needs "
                         "--bound_radius)")
    ap.add_argument("--opt_occ", action="store_true",
                    help="the trained category grid in the fitting loop "
                         "(needs --occ); eval renders without it")
    ap.add_argument("--opt_samples", type=int, default=None,
                    help="sample budget of the fitting loop only")
    ap.add_argument("--opt_rays", type=int, default=None,
                    help="rays drawn per fitting step instead of the full "
                         "target view (None: the reference protocol)")
    ap.add_argument("--geometry", type=str, default="sphere",
                    choices=["sphere", "chair"])
    ap.add_argument("--resume_train", action="store_true",
                    help="resume the training checkpoint under --out if "
                         "there is one (at --steps it goes straight to the "
                         "test split)")
    ap.add_argument("--tgt_views", type=str, default="1",
                    help="comma list of the conditioning views; eval "
                         "excludes all of them")
    ap.add_argument("--opt_group", type=int, default=1,
                    help="test objects fitted and evaluated together "
                         "(1: one at a time); per-object results are the "
                         "same")
    ap.add_argument("--save_images", type=int, default=8,
                    help="side-by-side PNGs for the first N test objects")
    ap.add_argument("--scene_cache", type=str, default=None,
                    help="directory caching generated scenes (entries "
                         "interchange with the JAX tool's)")
    ap.add_argument("--device_gt", action="store_true",
                    help="eval ground truth rendered on the device from "
                         "the test scene's generation parameters (needs "
                         "--opt_group > 1)")
    ap.add_argument("--scene_backend", type=str, default="numpy",
                    choices=("numpy", "device"),
                    help="synthetic render backend: numpy (f64, host) or "
                         "device (f32 on --device; the JAX tool's jax)")
    ap.add_argument("--codes_per_update", type=int, default=None)
    return ap


def check_args(args) -> None:
    """The JAX tool's refusal, made before any work: device ground truth
    is the batched eval's."""
    if args.device_gt and args.opt_group <= 1:
        raise ValueError("--device_gt needs --opt_group > 1 (the batched "
                         "eval renders the ground truth on the device)")


def load_scenes(args, seed: int, device=None):
    """``(scene, train_scene, test_scene, test_base)``: one category draw
    sliced into train and held-out objects, or with ``--n_test_views``
    two draws (the held-out one at scene seed ``+ 57``). The device
    backend renders on ``device`` (default ``args.device``)."""
    from codenerf_tpu_torch.data.synthetic import (synthetic_scene,
                                                   synthetic_scene_cached)

    def draw(**kw):
        # The numpy backend stays out of the cache key, as in the JAX
        # tool, so its entries resolve across both packages; a device
        # entry is keyed by its backend and device.
        if args.scene_cache:
            return synthetic_scene_cached(args.scene_cache, **kw)
        return synthetic_scene(**kw)

    common = dict(H=args.size, W=args.size, pattern=True,
                  geometry=args.geometry, cam_distance=args.cam_distance)
    if args.scene_backend != "numpy":
        common.update(backend=args.scene_backend,
                      device=str(device or args.device))
    if args.n_test_views is None:
        n_total = args.n_train_objects + args.n_test_objects
        scene = draw(n_objects=n_total, n_views=args.n_views,
                     seed=11 + 100 * seed, **common)
        n = args.n_train_objects
        train_scene = {"images": scene["images"][:n],
                       "poses": scene["poses"][:n],
                       "focals": scene["focals"][:n],
                       "H": scene["H"], "W": scene["W"]}
        return scene, train_scene, scene, n
    scene = draw(n_objects=args.n_train_objects, n_views=args.n_views,
                 seed=11 + 100 * seed, **common)
    test_scene = draw(n_objects=args.n_test_objects,
                      n_views=args.n_test_views, seed=11 + 100 * seed + 57,
                      **common)
    return scene, scene, test_scene, 0


def device_gt_leaves(args, seed: int, test_scene) -> dict:
    """The test scene's per-object generation parameters, drawn again
    with ``params_only`` and its exact arguments (the JAX tool's
    ``--device_gt``): ``albedo`` plus ``radius`` or ``boxes``/``yaw``.
    Fails if the draw's poses are not the scene's."""
    from codenerf_tpu_torch.data.synthetic import synthetic_scene

    n_objects, n_views = test_scene["poses"].shape[:2]
    tp = synthetic_scene(
        n_objects=n_objects, n_views=n_views, H=args.size, W=args.size,
        seed=(11 + 100 * seed) if args.n_test_views is None
        else (11 + 100 * seed + 57),
        pattern=True, geometry=args.geometry,
        cam_distance=args.cam_distance, params_only=True)
    if not np.array_equal(tp["poses"], test_scene["poses"]):
        raise AssertionError("the params-only draw diverged from the test "
                             "scene")
    if args.geometry == "chair":
        return dict(albedo=tp["albedos"], boxes=tp["boxes"], yaw=tp["yaws"])
    return dict(albedo=tp["albedos"], radius=tp["radii"])


def flagship_hparams(args, seed: int, scene, net=None):
    """The JAX tool's ``Hparams``: the flagship net (or ``net``), the
    scene's near/far, lr 5e-4 / 5e-3 without halving in the run, no
    periodic checkpoints."""
    from codenerf_tpu_torch.config import (Hparams, LrSchedule, NetConfig,
                                           RenderConfig,
                                           TrainOccupancyConfig)

    return Hparams(
        net=net or NetConfig(shape_blocks=3, texture_blocks=1, W=256,
                             num_xyz_freq=10, num_dir_freq=4,
                             latent_dim=256),
        render=RenderConfig(n_samples=args.samples, near=scene["near"],
                            far=scene["far"],
                            n_importance=args.n_importance,
                            bound_sphere_radius=args.bound_radius),
        lr_model=LrSchedule(5e-4, 1_000_000),
        lr_codes=LrSchedule(5e-3, 1_000_000),
        check_points=0,
        seed=seed,
        use_fused_train=args.use_fused,
        train_occupancy=TrainOccupancyConfig(
            codes_per_update=args.codes_per_update) if args.occ else None,
    )


def write_results(path: str, args, hp, seed: int, rows, train_time: float,
                  train_psnr: float, test_time: float, tgt) -> None:
    """``RESULTS.md`` in the JAX tool's layout; ``rows`` are (name, eval
    PSNR, eval SSIM, fitting start PSNR, fitting end PSNR)."""
    mean_psnr = float(np.mean([r[1] for r in rows]))
    mean_ssim = float(np.mean([r[2] for r in rows]))
    with open(path, "w") as f:
        f.write(
            "# Quality report (synthetic, reference eval protocol)\n\n"
            f"- config: W={hp.net.W}, {hp.net.shape_blocks}+"
            f"{hp.net.texture_blocks} blocks, {args.samples} samples/ray, "
            f"{args.size}x{args.size} images, {args.n_train_objects} train / "
            f"{args.n_test_objects} held-out objects, {args.n_views} views"
            + (f" train / {args.n_test_views} views test"
               if args.n_test_views is not None else "")
            + f", seed {seed}\n"
            f"- geometry: {args.geometry}\n"
            f"- kernels/sampling: use_fused={args.use_fused}, "
            f"bound_radius={args.bound_radius}, occupancy={args.occ}, "
            f"n_importance={args.n_importance}, opt_occ={args.opt_occ}, "
            f"opt_samples={args.opt_samples or args.samples}, "
            f"opt_rays={args.opt_rays or 'full-view'}\n"
            f"- training: {args.steps} steps (crop->full), "
            f"{train_time:.0f}s wall; final train PSNR "
            f"{train_psnr:.2f} dB\n"
            f"- test-time optimization: mean-code init, {args.num_opts} "
            f"AdamW steps on view(s) {tgt}, lr 1e-2 halved/50 "
            "(src/optimizer.py:48-135 protocol); "
            f"{args.n_test_objects} objects optimized+evaluated in "
            f"{test_time:.0f}s wall "
            f"({test_time / max(1, args.n_test_objects):.2f}s/object "
            "incl. compile)\n\n"
            "| object | eval PSNR (dB) | eval SSIM | opt start -> end (dB) |\n"
            "|---|---|---|---|\n"
        )
        for name, p, s, h0, h1 in rows:
            f.write(f"| {name} | {p:.2f} | {s:.4f} | {h0:.1f} -> {h1:.1f} |\n")
        f.write(f"| **mean** | **{mean_psnr:.2f}** | **{mean_ssim:.4f}** "
                "| |\n")


def write_summary(path: str, args, seeds, results) -> None:
    """``SUMMARY.md`` over seeds in the JAX tool's layout."""
    ps = np.array([r["psnr"] for r in results])
    ss = np.array([r["ssim"] for r in results])
    with open(path, "w") as f:
        f.write(
            "# Multi-seed quality summary\n\n"
            f"- config: {args.samples} samples"
            + (f" + {args.n_importance} importance"
               if args.n_importance else "") + ", "
            f"use_fused={args.use_fused}, "
            f"bound_radius={args.bound_radius}, occ={args.occ}, "
            f"{args.n_train_objects} train / {args.n_test_objects} "
            f"held-out objects, {args.n_views} views, {args.steps} "
            f"steps, seeds {seeds}\n\n"
            "| seed | held-out PSNR | held-out SSIM | train PSNR | train s |\n"
            "|---|---|---|---|---|\n")
        for r in results:
            f.write(f"| {r['seed']} | {r['psnr']:.2f} | {r['ssim']:.4f} "
                    f"| {r['train_psnr']:.2f} | {r['train_s']:.0f} |\n")
        f.write(
            f"| **mean ± std** | **{ps.mean():.2f} ± {ps.std(ddof=1):.2f}**"
            f" | **{ss.mean():.4f} ± {ss.std(ddof=1):.4f}** | | |\n")


def run_once(args, seed: int, out_dir: str, net=None,
             batch_size: int = 8192, device: Optional[str] = None) -> dict:
    """One seed of the protocol into ``out_dir``. ``net`` (a
    ``NetConfig``), ``batch_size`` and ``device`` override the flagship
    widths, the 8192-ray batch and ``args.device`` (the CPU tests run a
    narrow net). Returns the seed's means, the per-object rows, the fitted
    codes (a (shape, texture) pair of f32 arrays per object) and the
    host-clock seconds of training and of each object's fitting and eval
    (a group's share; ``fit_s``, ``eval_s``)."""
    import torch

    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer
    from codenerf_tpu_torch.training.trainer import Trainer
    from codenerf_tpu_torch.utils.images import save_png, side_by_side

    check_args(args)
    dev = resolve_device(device or args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    os.makedirs(out_dir, exist_ok=True)
    t0g = time.time()
    scene, train_scene, test_scene, test_base = load_scenes(args, seed, dev)
    if args.n_test_views is not None:
        print(f"[seed {seed}] scene gen: {args.n_train_objects}x"
              f"{args.n_views} train + {args.n_test_objects}x"
              f"{args.n_test_views} test views at {args.size}px in "
              f"{time.time() - t0g:.0f}s", flush=True)
    hp = flagship_hparams(args, seed, scene, net)

    t0 = time.time()
    trainer = Trainer(f"quality_s{seed}", hp, batch_size=batch_size,
                      dataset=train_scene, exps_root=out_dir, check_iter=0,
                      device=dev)
    if args.resume_train and trainer.resume():
        print(f"[seed {seed}] resumed training checkpoint at step "
              f"{int(trainer.state.step)}", flush=True)
    m = trainer.training(iters_crop=args.steps // 6, iters_all=args.steps,
                         log_every=max(100, args.steps // 10))
    sync()
    train_time = time.time() - t0
    train_psnr = float(m.get("psnr", float("nan")))
    print(f"[seed {seed}] train: {args.steps} steps in {train_time:.0f}s, "
          f"final train psnr {train_psnr:.2f} dB", flush=True)

    st = trainer.state
    if args.occ and trainer.occupancy_grid is not None:
        frac = float(trainer.occupancy_grid.occ.float().mean())
        print(f"[seed {seed}] occupancy grid: {frac:.3f} occupied "
              f"(k={trainer._occ_k}/{args.n_train_objects} per update)",
              flush=True)
    opt_hp = hp
    if args.opt_samples:
        opt_hp = dataclasses.replace(hp, render=dataclasses.replace(
            hp.render, n_samples=args.opt_samples))
    # Eval renders the full budget without the grid whatever the fitting
    # loop used, so held-out metrics compare across settings.
    optimizer = CodeOptimizer(
        st.model, opt_hp, mean_code(st.shape_codes.detach()),
        mean_code(st.texture_codes.detach()), chunk=4096, device=dev,
        occ_grid=trainer.occupancy_grid if args.opt_occ else None,
        eval_hp=hp, eval_occ=False, fine_model=st.fine_model,
        opt_rays=args.opt_rays)

    gt_leaves = None
    if args.device_gt:
        gt_leaves = device_gt_leaves(args, seed, test_scene)
    rows, fit_s, eval_s, codes = [], [], [], []
    t_test0 = time.time()
    master = torch.Generator().manual_seed(seed)
    group = max(1, args.opt_group)
    tgt = [int(v) for v in str(args.tgt_views).split(",")]
    for start in range(0, args.n_test_objects, group):
        idx = list(range(start, min(start + group, args.n_test_objects)))
        ois = [test_base + i for i in idx]
        gens = []
        for _ in idx:
            s_opt, s_eval = torch.randint(0, 2 ** 62, (2,), generator=master)
            gens.append((torch.Generator(device=dev).manual_seed(int(s_opt)),
                         torch.Generator(device=dev).manual_seed(int(s_eval))))
        imgs_g = test_scene["images"][ois]
        poses_g = test_scene["poses"][ois]
        focals_g = test_scene["focals"][ois]
        want_img = idx[0] < args.save_images
        sync()
        t_fit = time.time()
        # A group of one is the sequential loop: optimize_objects runs
        # each row as optimize_object runs that object.
        res = optimizer.optimize_objects(
            imgs_g, poses_g, focals_g, tgt, [g[0] for g in gens],
            num_opts=args.num_opts, lr=1e-2, lr_half_interval=50)
        hist = res.psnr_history
        codes += [(s.cpu().numpy(), t.cpu().numpy()) for s, t in zip(
            res.shape_codes, res.texture_codes)]
        sync()
        fit_s += [(time.time() - t_fit) / len(idx)] * len(idx)
        gt_params = None
        if gt_leaves is not None:
            gt_params = dict(geometry=args.geometry, pattern=True,
                             hw=(args.size, args.size),
                             **{k: v[ois] for k, v in gt_leaves.items()})
        t_eval = time.time()
        ev = optimizer.evaluate_objects(
            None if gt_params is not None else imgs_g, poses_g, focals_g,
            tgt, res.shape_codes, res.texture_codes, [g[1] for g in gens],
            return_images=want_img, gt_params=gt_params)
        sync()
        eval_s += [(time.time() - t_eval) / len(idx)] * len(idx)
        for j, i in enumerate(idx):
            rows.append((f"heldout_{i}", float(ev["psnr"][j].mean()),
                         float(ev["ssim"][j].mean()), float(hist[0, j]),
                         float(hist[-1, j])))
            if want_img and i < args.save_images:
                strip = side_by_side(
                    ev["images"][j][:3],
                    imgs_g[j][ev["views"][:3]].astype(np.float32) / 255.0)
                save_png(os.path.join(out_dir, f"heldout_{i}.png"), strip)
            print(f"[seed {seed}] object {i}: eval psnr {rows[-1][1]:.4f} "
                  f"dB, ssim {rows[-1][2]:.5f}; fit {rows[-1][3]:.4f} -> "
                  f"{rows[-1][4]:.4f} dB in {fit_s[-1]:.3f}s, eval "
                  f"{eval_s[-1]:.3f}s", flush=True)

    test_time = time.time() - t_test0
    mean_psnr = float(np.mean([r[1] for r in rows]))
    mean_ssim = float(np.mean([r[2] for r in rows]))
    write_results(os.path.join(out_dir, "RESULTS.md"), args, hp, seed, rows,
                  train_time, train_psnr, test_time, tgt)
    print(f"[seed {seed}] mean held-out PSNR {mean_psnr:.2f} dB, "
          f"SSIM {mean_ssim:.4f}", flush=True)
    return {"seed": seed, "psnr": mean_psnr, "ssim": mean_ssim,
            "train_psnr": train_psnr, "train_s": train_time,
            "test_s": test_time, "per_object_psnr": [r[1] for r in rows],
            "rows": rows, "fit_s": fit_s, "eval_s": eval_s, "codes": codes,
            "run_dir": trainer.save_dir}


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    check_args(args)
    os.makedirs(args.out, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    results = []
    for seed in seeds:
        results.append(run_once(args, seed,
                                os.path.join(args.out, f"seed{seed}")
                                if len(seeds) > 1 else args.out))
    if len(seeds) > 1:
        write_summary(os.path.join(args.out, "SUMMARY.md"), args, seeds,
                      results)
        ps = np.array([r["psnr"] for r in results])
        ss = np.array([r["ssim"] for r in results])
        print(f"\nSUMMARY: psnr {ps.mean():.2f} ± {ps.std(ddof=1):.2f} dB, "
              f"ssim {ss.mean():.4f} ± {ss.std(ddof=1):.4f}")
        print(f"wrote {args.out}/SUMMARY.md")
    print(json.dumps({"psnr_by_seed": [r["psnr"] for r in results]}))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
