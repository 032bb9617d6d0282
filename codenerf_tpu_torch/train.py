"""Category-level training CLI of the port:

    python -m codenerf_tpu_torch.train --jsonfile srncar_fused.json \\
        --save_dir <run> [--device cuda] [flags of the root train.py]

The flags and defaults are those of the root ``train.py`` (the reference
``train.py:12-19`` plus ``--resume``, ``--max_objects``, ``--tensorboard``,
``--log_every``, ``--check_iter``, ``--microbatch``), with ``--device``
(``cuda``, the default, or ``cpu``) and ``--gpu`` (the CUDA device index)
as the port's optimize CLI has them. One step is one globally-sampled
batch of ``--batchsize`` rays (16,384 = one 128×128 image's rays).

Writes ``<exps_root>/<save_dir>/{hpam.json, metrics.jsonl, ckpt/}``;
``python -m codenerf_tpu_torch.optimize --saved_dir <save_dir>`` reads the
latest ``ckpt/step_*.pt``. The mesh flags (``--data_axis``,
``--model_axis``, ``--replica_axis``) other than their defaults raise:
multi-GPU training is not ported yet.
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
    if args.data_axis not in (-1, 1) or args.model_axis != 1 \
            or args.replica_axis != 1:
        raise NotImplementedError(
            "--data_axis/--model_axis/--replica_axis (multi-device "
            "training) are not ported yet (ROADMAP.md Queue 1, item 12)")
    if args.num_instances_per_obj != 2:
        warnings.warn(f"--num_instances_per_obj={args.num_instances_per_obj}"
                      " is ignored: rays are sampled globally across all "
                      "objects and views each step", stacklevel=2)

    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.training.trainer import Trainer

    device = resolve_device(
        f"cuda:{args.gpu}" if args.device == "cuda" else args.device)
    hp = load_hparams(args.jsonfile)
    trainer = Trainer(args.save_dir, hp, batch_size=args.batchsize,
                      exps_root=args.exps_root,
                      use_tensorboard=args.tensorboard,
                      check_iter=args.check_iter,
                      max_objects=args.max_objects,
                      microbatch_rays=args.microbatch, device=device)
    if args.resume and trainer.resume():
        print(f"resumed from step {trainer.state.step}")
    metrics = trainer.training(args.iters_crop, args.iters_all,
                               log_every=args.log_every)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
