"""Test-time latent-code optimization + evaluation CLI of the port:

    python -m codenerf_tpu_torch.optimize --jsonfile srncar_fused.json \\
        --saved_dir <run> [--device cuda] [flags of the root optimize.py]

Protocol (reference ``src/optimizer.py:48-135``): per test object, start
the codes at the mean of the trained embeddings, run ``--num_opts`` AdamW
steps on the codes only against the ``--tgt_instances`` views (lr halved
every ``--lr_half_interval``), then report PSNR/SSIM over all other views.

Reads the run's training checkpoint, the latest
``<exps_root>/<saved_dir>/ckpt/step_*.pt`` that ``python -m
codenerf_tpu_torch.train`` writes (as the JAX CLI reads ``<run>/ckpt``),
the fine network included for a jsonfile with separate fine weights; a
run without ``ckpt/`` is read from ``models.pth`` in the reference layout
(``model_params``, ``shape_code_params``, ``texture_code_params``). Any
config the trainer takes runs, each on the JAX package's route
(``optimization/codes_opt.codes_route``), and any view size: a view whose
rays do not split into equal chunks is padded.
Writes
under ``<exps_root>/<saved_dir>/test[_N]/``, like the JAX CLI:
``opt_hpams.json``, ``codes.npz``, ``codes.pth`` (reference payload),
``results.json``, per-step progress PNGs (``--save_progress``) and
side-by-side eval PNGs (``--save_img``).

``--opt_occ true`` rebuilds the trained category's occupancy grid from the
checkpoint (``core/occupancy.rebuild_category_grid``; the jsonfile needs
``train_occupancy``) and bounds the optimization loop's depths with it;
``--opt_samples`` replaces ``N_samples`` for the optimization loop only.
Eval renders with the jsonfile's full budget and no grid either way, as
the JAX CLI does.

``--pose_opt`` dispatches to the joint pose + code optimization CLI
(``python -m codenerf_tpu_torch.pose_opt``, the twin of
``tools/pose_opt.py``) with the remaining flags, as the root
``optimize.py`` does.

``--opt_rays N`` fits each step on N target rays drawn at random
instead of the full view (no per-step progress PNGs then);
``--opt_group G`` fits G objects together under one AdamW and evaluates
them together, each object with the generators the sequential loop would
give it, so ``codes.npz`` and ``results.json`` are object-for-object the
sequential loop's.

On N cards, one process each:

    torchrun --standalone --nproc_per_node N -m codenerf_tpu_torch.optimize \
        --jsonfile srncar_fused.json --saved_dir <run> --opt_group G

Under ``torchrun``, or with ``--data_axis``/``--replica_axis`` off their
defaults, the processes form the JAX package's mesh
(``parallel/mesh.py``; a layout that does not match ``WORLD_SIZE``
raises ``ValueError``), and each group of ``--opt_group`` objects is
split over its batch shards: each process fits and scores its block of
the group, and every process holds the whole group's results. With
``--opt_group 1`` every process runs every object (a warning says so,
as in the JAX CLI). Rank 0 writes every output file, the files of a
one-process run.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--opt_occ", type=str2bool, default=False,
                   help="rebuild the trained category occupancy grid from "
                        "the checkpoint and use it in the optimization "
                        "loop (needs a jsonfile with train_occupancy); "
                        "eval renders without it")
    p.add_argument("--opt_samples", type=int, default=None,
                   help="sample budget of the optimization loop only (eval "
                        "keeps the jsonfile's N_samples)")
    p.add_argument("--pose_opt", action="store_true",
                   help="run joint camera-pose + code optimization instead "
                        "(python -m codenerf_tpu_torch.pose_opt takes every "
                        "other flag; see its --help)")
    p.add_argument("--opt_group", type=int, default=1,
                   help="test objects fitted and evaluated together (1: "
                        "one at a time); per-object results are the same")
    p.add_argument("--opt_rays", type=int, default=None,
                   help="target rays drawn per optimization step instead "
                        "of the full view (None: the reference protocol)")
    p.add_argument("--data_axis", type=int, default=-1)
    p.add_argument("--replica_axis", type=int, default=1,
                   help="with several processes, --opt_group objects split "
                        "over a (replica, data) mesh; per-object results "
                        "are the same")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the summary rows and host-clock timings (with
    ``--pose_opt``, what ``pose_opt.main`` returns)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--pose_opt" in argv:
        from codenerf_tpu_torch import pose_opt

        return pose_opt.main([a for a in argv if a != "--pose_opt"])
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from codenerf_tpu_torch.parallel.mesh import mesh_from_flags

    mesh, device = mesh_from_flags(
        f"cuda:{args.gpu}" if args.device == "cuda" else args.device,
        data=args.data_axis, replica=args.replica_axis)
    try:
        return _run(args, mesh, device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(args, mesh, device) -> dict:
    import torch.distributed as dist

    from codenerf_tpu_torch.config import resolve_dtype
    from codenerf_tpu_torch.core.occupancy import rebuild_category_grid
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.models.codes import mean_code
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer
    from codenerf_tpu_torch.parallel.mesh import is_writer, n_batch_shards
    from codenerf_tpu_torch.utils.checkpoint import load_run, \
        save_reference_codes
    from codenerf_tpu_torch.utils.images import save_png, side_by_side

    hp = load_hparams(args.jsonfile)
    if args.opt_occ and hp.train_occupancy is None:
        raise SystemExit(f"--opt_occ needs a jsonfile with train_occupancy "
                         f"(e.g. srncar_hier_occ.json); {args.jsonfile} has "
                         "none")
    if mesh is not None and n_batch_shards(mesh) > 1 and args.opt_group == 1:
        print("WARNING: several processes but --opt_group=1: the mesh "
              "splits the object-group axis; every process runs every "
              "object. Raise --opt_group to use every card.",
              file=sys.stderr)
    writer = is_writer()
    run_dir = os.path.join(args.exps_root, args.saved_dir)
    model, fine_model, shape_codes, texture_codes = load_run(run_dir, hp,
                                                             device)
    save_dir = [_unique_test_dir(os.path.join(run_dir, "test"))
                if writer else None]
    if mesh is not None:
        dist.broadcast_object_list(save_dir, src=0)
    save_dir = save_dir[0]
    print("we are going to save at", save_dir)

    obj = hp.data.cat.split("_")[1]
    ds = SRNDataset(cat=hp.data.cat, splits=f"{obj}_{args.splits}",
                    data_dir=hp.data.data_dir, max_objects=args.max_objects)
    occ = None
    if args.opt_occ:
        # The density is a function of the trainables and is not
        # checkpointed: rebuild the category grid from the checkpoint, as
        # the trainer does on a resume past its warm-up.
        oc = hp.train_occupancy
        occ = rebuild_category_grid(
            model, shape_codes.to(device), texture_codes.to(device),
            oc, oc.radius if oc.radius is not None
            else hp.render.bound_sphere_radius,
            compute_dtype=resolve_dtype(hp.compute_dtype))
    opt_hp = hp
    if args.opt_samples:
        opt_hp = dataclasses.replace(hp, render=dataclasses.replace(
            hp.render, n_samples=args.opt_samples))
    optimizer = CodeOptimizer(model, opt_hp, mean_code(shape_codes),
                              mean_code(texture_codes), chunk=args.batchsize,
                              device=device, occ_grid=occ, eval_hp=hp,
                              eval_occ=False, fine_model=fine_model,
                              opt_rays=args.opt_rays, mesh=mesh)

    if writer:
        with open(os.path.join(save_dir, "opt_hpams.json"), "w") as f:
            json.dump({"instance_ids": args.tgt_instances, "lr": args.lr,
                       "lr_half_interval": args.lr_half_interval,
                       "splits": args.splits, "num_opts": args.num_opts},
                      f, indent=2)

    n = ds.n_objects
    latent_dim = optimizer.mean_shape.shape[-1]
    out = {"ids": np.asarray(ds.ids),
           "optimized_shapecodes": np.zeros((n, latent_dim), np.float32),
           "optimized_texturecodes": np.zeros((n, latent_dim), np.float32)}
    psnr_eval, ssim_eval, summary, histories = {}, {}, [], {}
    timing = {"opt_s": 0.0, "opt_steps": 0, "eval_s": 0.0, "eval_views": 0}
    master = torch.Generator().manual_seed(hp.seed)
    group = max(1, args.opt_group)
    if group > 1 and args.save_progress:
        print("WARNING: --opt_group disables per-step progress PNGs "
              "(batched optimization collects no per-step renders)",
              file=sys.stderr)
        args.save_progress = False
    if args.opt_rays is not None and args.save_progress:
        print("WARNING: --opt_rays disables per-step progress PNGs "
              "(a ray minibatch is not a full view)", file=sys.stderr)
        args.save_progress = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def generators():
        """One object's fitting and eval generators, drawn from the master
        in object order whatever the loop's shape."""
        s_opt, s_eval = torch.randint(0, 2 ** 62, (2,), generator=master)
        return (torch.Generator(device=device).manual_seed(int(s_opt)),
                torch.Generator(device=device).manual_seed(int(s_eval)))

    def emit(oi, imgs, shape_code, texture_code, hist, ev, j=None):
        """One object's results and images; ``j`` is its row in a batched
        ``ev``."""
        pick = (lambda k: ev[k]) if j is None else (lambda k: ev[k][j])
        out["optimized_shapecodes"][oi] = shape_code.cpu().numpy()
        out["optimized_texturecodes"][oi] = texture_code.cpu().numpy()
        histories[ds.ids[oi]] = np.asarray(hist).tolist()
        psnr_eval[ds.ids[oi]] = pick("psnr").tolist()
        ssim_eval[ds.ids[oi]] = pick("ssim").tolist()
        summary.append({"id": ds.ids[oi],
                        "psnr": float(np.mean(pick("psnr"))),
                        "ssim": float(np.mean(pick("ssim")))})
        print(f"  psnr {summary[-1]['psnr']:.3f}  ssim "
              f"{summary[-1]['ssim']:.4f}")
        if writer and args.save_img:
            obj_dir = os.path.join(save_dir, ds.ids[oi])
            os.makedirs(obj_dir, exist_ok=True)
            imgs_f = imgs.astype(np.float32) / 255.0
            for k, v in enumerate(ev["views"]):
                save_png(os.path.join(obj_dir,
                                      f"{v}_{len(args.tgt_instances)}.png"),
                         side_by_side(pick("images")[k], imgs_f[v]))

    def flush(num_obj):
        """``codes.npz``, ``results.json`` and the reference ``codes.pth``:
        once per object on the sequential loop, once per group on the
        batched one."""
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
            os.path.join(save_dir, "codes.pth"), ids=out["ids"],
            num_obj=num_obj, shape_codes=out["optimized_shapecodes"],
            texture_codes=out["optimized_texturecodes"],
            psnr_eval={i: psnr_eval[d] for i, d in enumerate(ds.ids)
                       if d in psnr_eval},
            ssim_eval={i: ssim_eval[d] for i, d in enumerate(ds.ids)
                       if d in ssim_eval})

    for start in range(0, n, group):
        idx = list(range(start, min(start + group, n)))
        print(f"num obj: {idx[0]}/{n}" if group == 1 else
              f"num obj: {idx[0]}..{idx[-1]}/{n}")
        gens = [generators() for _ in idx]
        sync()
        t0 = time.perf_counter()
        if group == 1:
            oi = idx[0]
            imgs = ds.images[oi]
            poses, focal = ds.poses[oi], float(ds.focals[oi])
            res = optimizer.optimize_object(
                imgs, poses, focal, args.tgt_instances, gens[0][0],
                num_opts=args.num_opts, lr=args.lr,
                lr_half_interval=args.lr_half_interval,
                progress_images=args.save_progress)
            sync()
            t1 = time.perf_counter()
            ev = optimizer.evaluate_object(
                imgs, poses, focal, args.tgt_instances, res.shape_code,
                res.texture_code, gens[0][1], return_images=args.save_img,
                deterministic=args.deterministic_eval)
            rows = [(oi, imgs, res.shape_code, res.texture_code,
                     res.psnr_history, None)]
        else:
            imgs_g = np.stack([ds.images[i] for i in idx])
            poses_g = np.stack([ds.poses[i] for i in idx])
            focals_g = np.asarray([ds.focals[i] for i in idx], np.float32)
            res = optimizer.optimize_objects(
                imgs_g, poses_g, focals_g, args.tgt_instances,
                [g[0] for g in gens], num_opts=args.num_opts, lr=args.lr,
                lr_half_interval=args.lr_half_interval)
            sync()
            t1 = time.perf_counter()
            ev = optimizer.evaluate_objects(
                imgs_g, poses_g, focals_g, args.tgt_instances,
                res.shape_codes, res.texture_codes, [g[1] for g in gens],
                return_images=args.save_img,
                deterministic=args.deterministic_eval)
            rows = [(oi, imgs_g[j], res.shape_codes[j], res.texture_codes[j],
                     res.psnr_history[:, j], j) for j, oi in enumerate(idx)]
        sync()
        t2 = time.perf_counter()
        timing["opt_s"] += t1 - t0
        timing["opt_steps"] += args.num_opts * len(idx)
        timing["eval_s"] += t2 - t1
        timing["eval_views"] += len(ev["views"]) * len(idx)
        if writer and args.save_progress:   # the sequential loop's object
            obj_dir = os.path.join(save_dir, ds.ids[idx[0]])
            os.makedirs(obj_dir, exist_ok=True)
            v0 = args.tgt_instances[0]
            prog = res.progress.cpu().numpy()
            gt_v0 = rows[0][1][v0].astype(np.float32) / 255.0
            for t in range(prog.shape[0]):
                save_png(os.path.join(obj_dir, f"opt{t:03d}_{v0}.png"),
                         side_by_side(prog[t], gt_v0))
        for oi, imgs, shape_code, texture_code, hist, j in rows:
            emit(oi, imgs, shape_code, texture_code, hist, ev, j)
        if writer:
            flush(idx[-1])
    print("done:", json.dumps(summary[-1] if summary else {}))
    return {"save_dir": save_dir, "summary": summary, "timing": timing,
            "psnr_history": histories}


if __name__ == "__main__":
    main(sys.argv[1:])
