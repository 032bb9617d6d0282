"""Pose + latent-code optimization CLI of the port (the twin of
``tools/pose_opt.py``):

    python -m codenerf_tpu_torch.pose_opt --saved_dir <run> \\
        --jsonfile srncar_hier_occ.json [--device cuda] [--gpu 0] \\
        [--tgt_instance 1 --perturb_rot 6 --perturb_trans 0.1 ...]

``python -m codenerf_tpu_torch.optimize --pose_opt ...`` dispatches here
with the remaining flags.

Protocol, per test object: take view ``--tgt_instance``, whose camera pose
is treated as unknown: the ground-truth pose perturbed by a seeded random
se(3) twist of ``--perturb_rot`` degrees and ``--perturb_trans`` units
(numpy-seeded from ``--seed``, so the initial poses are the JAX tool's up
to the rounding of ``exp_se3``), or another view's pose
(``--init_view``). Start the codes at the mean of the trained embeddings
and recover (pose, codes) jointly with
``optimization/pose_opt.optimize_pose_and_codes`` (stochastic ray
minibatches; the codes frozen for the first ``--pose_only_steps``, by
default 3/4 of ``--num_opts``). Report the rotation and translation error
before and after against the ground-truth pose.

Reads the run as the port's optimize CLI does: the latest
``<exps_root>/<saved_dir>/ckpt/step_*.pt`` (with the fine network of a
separate-fine config), else ``models.pth``. Writes
under ``<exps_root>/<saved_dir>/pose_opt[_N]/``: ``results.json`` (per
object pose errors and first/last PSNR) and ``<obj_id>.png``, the
[initial-guess render | refined render | GT] strip (``--save_img``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from codenerf_tpu_torch.utils.images import str2bool


def rotation_error_deg(a: np.ndarray, b: np.ndarray) -> float:
    """Geodesic angle between two c2w rotations, degrees."""
    rel = np.asarray(a)[:3, :3].T @ np.asarray(b)[:3, :3]
    c = np.clip((np.trace(rel) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def translation_error(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3]))


def perturbation_twist(rng: np.random.Generator, rot_deg: float,
                       trans: float) -> np.ndarray:
    """A seeded twist of the requested magnitude: a unit axis times the
    angle, a unit direction times the distance; (6,) float32."""
    ax = rng.standard_normal(3)
    ax /= np.linalg.norm(ax)
    dxyz = rng.standard_normal(3)
    dxyz /= np.linalg.norm(dxyz)
    return np.concatenate([ax * np.radians(rot_deg),
                           dxyz * trans]).astype(np.float32)


def _unique_dir(base: str) -> str:
    path, num = base, 2
    while os.path.isdir(path):
        path = f"{base}_{num}"
        num += 1
    os.makedirs(path)
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Joint camera-pose + latent-code optimization (PyTorch)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    ap.add_argument("--saved_dir", type=str, default="default")
    ap.add_argument("--jsonfile", type=str, default="srncar.json")
    ap.add_argument("--splits", type=str, default="test")
    ap.add_argument("--exps_root", type=str, default="exps")
    ap.add_argument("--tgt_instance", type=int, default=1,
                    help="view index optimized against (its pose is the "
                    "unknown)")
    ap.add_argument("--perturb_rot", type=float, default=6.0,
                    help="rotation perturbation (degrees) of the GT pose")
    ap.add_argument("--perturb_trans", type=float, default=0.1,
                    help="translation perturbation magnitude")
    ap.add_argument("--init_view", type=int, default=None,
                    help="use this view's pose as the initial guess instead "
                    "of perturbing the target's; overrides --perturb_*")
    ap.add_argument("--num_opts", type=int, default=400)
    ap.add_argument("--lr_pose", type=float, default=1e-2)
    ap.add_argument("--lr_codes", type=float, default=1e-3)
    ap.add_argument("--lr_half_interval", type=int, default=100)
    ap.add_argument("--rays_per_step", type=int, default=2048,
                    help="stochastic ray minibatch per step")
    ap.add_argument("--pose_only_steps", type=int, default=None,
                    help="codes frozen for the first k steps (default 3/4 "
                    "of --num_opts: register first, then fine-tune jointly)")
    ap.add_argument("--max_objects", type=int, default=None)
    ap.add_argument("--save_img", type=str2bool, default=True)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns the save directory, the per-object rows and
    host-clock timings."""
    args = build_parser().parse_args(argv)

    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.config import load_hparams, resolve_dtype
    from codenerf_tpu_torch.core.poses import exp_se3
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.pose_opt import \
        optimize_pose_and_codes
    from codenerf_tpu_torch.renderer import render_image
    from codenerf_tpu_torch.utils.checkpoint import load_run
    from codenerf_tpu_torch.utils.images import image_float_to_uint8, save_png

    device = resolve_device(
        f"cuda:{args.gpu}" if args.device == "cuda" else args.device)
    hp = load_hparams(args.jsonfile)
    run_dir = os.path.join(args.exps_root, args.saved_dir)
    model, fine_model, shape_codes, texture_codes = load_run(run_dir, hp,
                                                             device)
    save_dir = _unique_dir(os.path.join(run_dir, "pose_opt"))
    print("we are going to save at", save_dir)

    obj = hp.data.cat.split("_")[1]
    ds = SRNDataset(cat=hp.data.cat, splits=f"{obj}_{args.splits}",
                    data_dir=hp.data.data_dir, max_objects=args.max_objects)
    mean_shape = mean_code(shape_codes).to(device)
    mean_texture = mean_code(texture_codes).to(device)
    pose_only = (3 * args.num_opts // 4 if args.pose_only_steps is None
                 else args.pose_only_steps)
    cd = resolve_dtype(hp.compute_dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(args.seed)
    master = torch.Generator().manual_seed(args.seed)
    results = []
    timing = {"opt_s": 0.0, "opt_steps": 0}
    for oi in range(ds.n_objects):
        print(f"num obj: {oi}/{ds.n_objects}")
        v = args.tgt_instance
        image_np = ds.images[oi, v].astype(np.float32) / 255.0
        image = torch.from_numpy(image_np).to(device)
        gt_pose = np.asarray(ds.poses[oi, v], np.float32)
        focal = float(ds.focals[oi])
        if args.init_view is not None:
            init_pose = np.asarray(ds.poses[oi, args.init_view], np.float32)
        else:
            xi = perturbation_twist(rng, args.perturb_rot, args.perturb_trans)
            init_pose = (exp_se3(torch.from_numpy(xi))
                         @ torch.from_numpy(gt_pose)).numpy()
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=master))
        gen = torch.Generator(device=device).manual_seed(seed)
        init_t = torch.from_numpy(init_pose).to(device)
        sync()
        t0 = time.perf_counter()
        res = optimize_pose_and_codes(
            model, hp, image, init_t, focal, mean_shape, mean_texture, gen,
            num_opts=args.num_opts, lr_codes=args.lr_codes,
            lr_pose=args.lr_pose, lr_half_interval=args.lr_half_interval,
            rays_per_step=args.rays_per_step, pose_only_steps=pose_only,
            fine_model=fine_model)
        sync()
        timing["opt_s"] += time.perf_counter() - t0
        timing["opt_steps"] += args.num_opts
        refined = res.c2w.cpu().numpy()
        hist = res.psnr_history
        row = {
            "id": ds.ids[oi],
            "rot_err_deg_before": rotation_error_deg(init_pose, gt_pose),
            "rot_err_deg_after": rotation_error_deg(refined, gt_pose),
            "trans_err_before": translation_error(init_pose, gt_pose),
            "trans_err_after": translation_error(refined, gt_pose),
            "psnr_first": float(hist[0]),
            "psnr_last": float(hist[-1]),
        }
        results.append(row)
        print(f"  rot {row['rot_err_deg_before']:.2f} -> "
              f"{row['rot_err_deg_after']:.2f} deg; trans "
              f"{row['trans_err_before']:.4f} -> {row['trans_err_after']:.4f}"
              f"; psnr {row['psnr_first']:.2f} -> {row['psnr_last']:.2f}")
        if args.save_img:
            H, W = image_np.shape[:2]

            def rend(pose):
                return render_image(
                    model, hp.render, H, W, focal, pose, res.shape_code,
                    res.texture_code, None, chunk=min(4096, H * W),
                    compute_dtype=cd, fine_model=fine_model).cpu().numpy()

            strip = np.concatenate([rend(init_pose), rend(refined),
                                    image_np], axis=1)
            save_png(os.path.join(save_dir, f"{ds.ids[oi]}.png"),
                     image_float_to_uint8(strip))
        with open(os.path.join(save_dir, "results.json"), "w") as f:
            json.dump({
                "args": vars(args),
                "per_object": results,
                "mean_rot_err_deg_after": float(np.mean(
                    [r["rot_err_deg_after"] for r in results])),
                "mean_trans_err_after": float(np.mean(
                    [r["trans_err_after"] for r in results])),
            }, f, indent=2)
    print("done:", json.dumps(results[-1] if results else {}))
    return {"save_dir": save_dir, "per_object": results, "timing": timing}


if __name__ == "__main__":
    main(sys.argv[1:])
