"""Category-level training CLI of the port:

    python -m codenerf_tpu_torch.train --jsonfile srncar_fused.json \\
        --save_dir <run> [--device cuda] [flags of the root train.py]

The flags and defaults are those of the root ``train.py`` (the reference
``train.py:12-19`` plus ``--resume``, ``--max_objects``, ``--tensorboard``,
``--log_every``, ``--check_iter``, ``--microbatch``), with ``--device``
(``cuda``, the default, or ``cpu``) and ``--gpu`` (the CUDA device index)
as the port's optimize CLI has them. One step is one globally-sampled
batch of ``--batchsize`` rays (16,384 = one 128×128 image's rays).

Any configuration of the JAX package's routes runs: the single-pass
loss kernel, the plane-op kernels (``fused_composite: false``, or
hierarchical sampling with separate fine weights,
``hierarchical_share_weights: false``, whose checkpoints hold the fine
network too) and plain autodiff, hierarchical ones with the training
occupancy grid included (``srncar_hier_occ.json``).

Writes ``<exps_root>/<save_dir>/{hpam.json, metrics.jsonl, ckpt/}``;
``python -m codenerf_tpu_torch.optimize --saved_dir <save_dir>`` reads the
latest ``ckpt/step_*.pt``.

Data-parallel training on N cards, one process each:

    torchrun --standalone --nproc_per_node N -m codenerf_tpu_torch.train \
        --jsonfile srncar_fused.json --save_dir <run> [--data_axis N]

Under ``torchrun``, or with a mesh flag off its default, the processes
form the JAX package's mesh (``parallel/mesh.py``): ``(data, model)``, or
``(replica, data, model)`` with ``--replica_axis`` above 1.
``--data_axis`` (-1: every process not on another axis) and
``--replica_axis`` (JAX's multi-slice axis) split each step's
``--batchsize`` rays over their product, each process on
``cuda:LOCAL_RANK`` (``--gpu`` is then unused). ``--model_axis M``
(tensor parallelism) splits the training state over M processes — each
keeps its slices of the layers and code tables JAX's shape rule shards
and gathers them whole for each forward — on the autodiff route only
(``srncar.json``, ``srncar_hierarchical.json``; a ``use_fused_train``
config raises JAX's ``ValueError``):

    torchrun --standalone --nproc_per_node 2 -m codenerf_tpu_torch.train \
        --jsonfile srncar.json --save_dir <run> --model_axis 2

A layout that does not match ``WORLD_SIZE`` raises ``ValueError``. Rank 0
writes the run directory; its checkpoints hold the whole state, so a run
resumes under any layout. NCCL needs a card for each rank; ranks that
share a card join over ``gloo`` from Python
(``parallel.mesh.init_from_env(backend="gloo")``, as ``chip_smoke.py``
phase 17 does).
"""

from __future__ import annotations

import argparse
import sys
import warnings

from codenerf_tpu_torch.utils.images import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train CodeNeRF (PyTorch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--save_dir", type=str, default="default")
    p.add_argument("--iters_crop", type=int, default=1_000_000)
    p.add_argument("--iters_all", type=int, default=1_200_000)
    p.add_argument("--batchsize", type=int, default=16384)
    p.add_argument("--jsonfile", type=str, default="srncar.json")
    p.add_argument("--num_instances_per_obj", type=int, default=2,
                   help="ignored: rays are sampled globally per step")
    p.add_argument("--exps_root", type=str, default="exps")
    p.add_argument("--data_axis", type=int, default=-1)
    p.add_argument("--model_axis", type=int, default=1)
    p.add_argument("--replica_axis", type=int, default=1)
    p.add_argument("--resume", type=str2bool, default=True)
    p.add_argument("--tensorboard", type=str2bool, default=False)
    p.add_argument("--max_objects", type=int, default=None)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--check_iter", type=int, default=10000)
    p.add_argument("--microbatch", type=int, default=0,
                   help="rays per gradient-accumulation microbatch "
                        "(0 = whole batch at once)")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the final logged metrics."""
    args = build_parser().parse_args(argv)
    if args.num_instances_per_obj != 2:
        warnings.warn(f"--num_instances_per_obj={args.num_instances_per_obj}"
                      " is ignored: rays are sampled globally across all "
                      "objects and views each step", stacklevel=2)

    import torch.distributed as dist

    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.parallel.mesh import mesh_from_flags
    from codenerf_tpu_torch.training.trainer import Trainer

    mesh, device = mesh_from_flags(
        f"cuda:{args.gpu}" if args.device == "cuda" else args.device,
        data=args.data_axis, model=args.model_axis,
        replica=args.replica_axis)
    try:
        hp = load_hparams(args.jsonfile)
        trainer = Trainer(args.save_dir, hp, batch_size=args.batchsize,
                          exps_root=args.exps_root,
                          use_tensorboard=args.tensorboard,
                          check_iter=args.check_iter,
                          max_objects=args.max_objects,
                          microbatch_rays=args.microbatch, device=device,
                          mesh=mesh)
        if args.resume and trainer.resume():
            print(f"resumed from step {trainer.state.step}")
        metrics = trainer.training(args.iters_crop, args.iters_all,
                                   log_every=args.log_every)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
