"""Test-time latent-code optimization + evaluation CLI of the port:

    python -m codenerf_tpu_torch.optimize --jsonfile srncar_fused.json \\
        --saved_dir <run> [--device cuda] [flags of the root optimize.py]

Protocol (reference ``src/optimizer.py:48-135``): per test object, start
the codes at the mean of the trained embeddings, run ``--num_opts`` AdamW
steps on the codes only against the ``--tgt_instances`` views (lr halved
every ``--lr_half_interval``), then report PSNR/SSIM over all other views.

Reads the run's training checkpoint, the latest
``<exps_root>/<saved_dir>/ckpt/step_*.pt`` that ``python -m
codenerf_tpu_torch.train`` writes (as the JAX CLI reads ``<run>/ckpt``);
a run without ``ckpt/`` is read from ``models.pth`` in the reference
layout (``model_params``, ``shape_code_params``, ``texture_code_params``).
Writes
under ``<exps_root>/<saved_dir>/test[_N]/``, like the JAX CLI:
``opt_hpams.json``, ``codes.npz``, ``codes.pth`` (reference payload),
``results.json``, per-step progress PNGs (``--save_progress``) and
side-by-side eval PNGs (``--save_img``).

Flags of the JAX CLI that this slice does not port (``--opt_group`` > 1,
``--opt_rays``, ``--opt_occ``, ``--opt_samples``, ``--pose_opt``,
multi-device axes) raise with the ROADMAP.md item that covers them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from codenerf_tpu_torch.config import load_hparams
from codenerf_tpu_torch.utils.images import str2bool


def _unique_test_dir(base: str) -> str:
    path, num = base, 2
    while os.path.isdir(path):
        path = f"{base}_{num}"
        num += 1
    os.makedirs(path)
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Optimize CodeNeRF codes (PyTorch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--saved_dir", type=str, default="default")
    p.add_argument("--tgt_instances", type=int, nargs="+", default=[1])
    p.add_argument("--splits", type=str, default="test")
    p.add_argument("--num_opts", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--lr_half_interval", type=int, default=50)
    p.add_argument("--save_img", type=str2bool, default=True)
    p.add_argument("--save_progress", type=str2bool, default=True)
    p.add_argument("--jsonfile", type=str, default="srncar.json")
    p.add_argument("--batchsize", type=int, default=4096)
    p.add_argument("--exps_root", type=str, default="exps")
    p.add_argument("--max_objects", type=int, default=None)
    p.add_argument("--deterministic_eval", type=str2bool, default=False)
    # Flags of the JAX CLI outside this slice: accepted so the surface
    # matches, refused unless left at their defaults.
    p.add_argument("--pose_opt", action="store_true")
    p.add_argument("--opt_group", type=int, default=1)
    p.add_argument("--opt_rays", type=int, default=None)
    p.add_argument("--opt_occ", type=str2bool, default=False)
    p.add_argument("--opt_samples", type=int, default=None)
    p.add_argument("--data_axis", type=int, default=-1)
    p.add_argument("--replica_axis", type=int, default=1)
    return p


def _refuse_unported(args) -> None:
    unported = [
        (args.pose_opt, "--pose_opt (pose optimization)",
         "Queue 1, item 10"),
        (args.opt_group > 1, "--opt_group > 1 (batched objects)",
         "Queue 1, item 7"),
        (args.opt_rays is not None, "--opt_rays (stochastic ray minibatches)",
         "Queue 1, item 7"),
        (args.opt_occ, "--opt_occ (occupancy grid)", "Queue 1, item 8"),
        (args.opt_samples is not None, "--opt_samples", "Queue 1, item 8"),
        (args.replica_axis != 1 or args.data_axis not in (-1, 1),
         "--data_axis/--replica_axis (multi-device)", "Queue 1, item 12"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md {item})")


def main(argv=None) -> dict:
    """Run the CLI; returns the summary rows and host-clock timings."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer
    from codenerf_tpu_torch.renderer import check_render_config
    from codenerf_tpu_torch.utils.checkpoint import (
        latest_step, load_reference_checkpoint, load_training_checkpoint,
        save_reference_codes)
    from codenerf_tpu_torch.utils.images import save_png, side_by_side

    device = resolve_device(
        f"cuda:{args.gpu}" if args.device == "cuda" else args.device)
    hp = load_hparams(args.jsonfile)
    check_render_config(hp.render)
    run_dir = os.path.join(args.exps_root, args.saved_dir)
    if latest_step(os.path.join(run_dir, "ckpt")) is not None:
        state, shape_codes, texture_codes = load_training_checkpoint(
            os.path.join(run_dir, "ckpt"))
    else:
        state, shape_codes, texture_codes = load_reference_checkpoint(
            os.path.join(run_dir, "models.pth"))
    model = CodeNeRF(hp.net)
    model.load_state_dict(state)
    save_dir = _unique_test_dir(os.path.join(run_dir, "test"))
    print("we are going to save at", save_dir)

    obj = hp.data.cat.split("_")[1]
    ds = SRNDataset(cat=hp.data.cat, splits=f"{obj}_{args.splits}",
                    data_dir=hp.data.data_dir, max_objects=args.max_objects)
    optimizer = CodeOptimizer(model, hp, mean_code(shape_codes),
                              mean_code(texture_codes), chunk=args.batchsize,
                              device=device)

    with open(os.path.join(save_dir, "opt_hpams.json"), "w") as f:
        json.dump({"instance_ids": args.tgt_instances, "lr": args.lr,
                   "lr_half_interval": args.lr_half_interval,
                   "splits": args.splits, "num_opts": args.num_opts}, f,
                  indent=2)

    n = ds.n_objects
    latent_dim = optimizer.mean_shape.shape[-1]
    out = {"ids": np.asarray(ds.ids),
           "optimized_shapecodes": np.zeros((n, latent_dim), np.float32),
           "optimized_texturecodes": np.zeros((n, latent_dim), np.float32)}
    psnr_eval, ssim_eval, summary, histories = {}, {}, [], {}
    timing = {"opt_s": 0.0, "opt_steps": 0, "eval_s": 0.0, "eval_views": 0}
    master = torch.Generator().manual_seed(hp.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for oi in range(n):
        print(f"num obj: {oi}/{n}")
        imgs = ds.images[oi]
        poses, focal = ds.poses[oi], float(ds.focals[oi])
        s_opt, s_eval = torch.randint(0, 2 ** 62, (2,), generator=master)
        g_opt = torch.Generator(device=device).manual_seed(int(s_opt))
        g_eval = torch.Generator(device=device).manual_seed(int(s_eval))
        sync()
        t0 = time.perf_counter()
        res = optimizer.optimize_object(
            imgs, poses, focal, args.tgt_instances, g_opt,
            num_opts=args.num_opts, lr=args.lr,
            lr_half_interval=args.lr_half_interval,
            progress_images=args.save_progress)
        sync()
        t1 = time.perf_counter()
        ev = optimizer.evaluate_object(
            imgs, poses, focal, args.tgt_instances, res.shape_code,
            res.texture_code, g_eval, return_images=args.save_img,
            deterministic=args.deterministic_eval)
        sync()
        t2 = time.perf_counter()
        timing["opt_s"] += t1 - t0
        timing["opt_steps"] += args.num_opts
        timing["eval_s"] += t2 - t1
        timing["eval_views"] += len(ev["views"])

        obj_dir = os.path.join(save_dir, ds.ids[oi])
        if args.save_progress or args.save_img:
            os.makedirs(obj_dir, exist_ok=True)
        if args.save_progress:
            v0 = args.tgt_instances[0]
            prog = res.progress.cpu().numpy()
            gt_v0 = imgs[v0].astype(np.float32) / 255.0
            for t in range(prog.shape[0]):
                save_png(os.path.join(obj_dir, f"opt{t:03d}_{v0}.png"),
                         side_by_side(prog[t], gt_v0))
        out["optimized_shapecodes"][oi] = res.shape_code.cpu().numpy()
        out["optimized_texturecodes"][oi] = res.texture_code.cpu().numpy()
        histories[ds.ids[oi]] = res.psnr_history.tolist()
        psnr_eval[ds.ids[oi]] = ev["psnr"].tolist()
        ssim_eval[ds.ids[oi]] = ev["ssim"].tolist()
        summary.append({"id": ds.ids[oi], "psnr": float(np.mean(ev["psnr"])),
                        "ssim": float(np.mean(ev["ssim"]))})
        print(f"  psnr {np.mean(ev['psnr']):.3f}  ssim "
              f"{np.mean(ev['ssim']):.4f}")
        if args.save_img:
            imgs_f = imgs.astype(np.float32) / 255.0
            for j, v in enumerate(ev["views"]):
                save_png(os.path.join(obj_dir,
                                      f"{v}_{len(args.tgt_instances)}.png"),
                         side_by_side(ev["images"][j], imgs_f[v]))

        np.savez(os.path.join(save_dir, "codes.npz"), **out)
        with open(os.path.join(save_dir, "results.json"), "w") as f:
            json.dump({"per_object": summary,
                       "psnr_eval": psnr_eval, "ssim_eval": ssim_eval,
                       "mean_psnr": float(np.mean([s["psnr"]
                                                   for s in summary])),
                       "mean_ssim": float(np.mean([s["ssim"]
                                                   for s in summary]))},
                      f, indent=2)
        save_reference_codes(
            os.path.join(save_dir, "codes.pth"), ids=out["ids"], num_obj=oi,
            shape_codes=out["optimized_shapecodes"],
            texture_codes=out["optimized_texturecodes"],
            psnr_eval={i: psnr_eval[d] for i, d in enumerate(ds.ids)
                       if d in psnr_eval},
            ssim_eval={i: ssim_eval[d] for i, d in enumerate(ds.ids)
                       if d in ssim_eval})
    print("done:", json.dumps(summary[-1] if summary else {}))
    return {"save_dir": save_dir, "summary": summary, "timing": timing,
            "psnr_history": histories}


if __name__ == "__main__":
    main(sys.argv[1:])
