"""Export a port training checkpoint to the reference's ``models.pth``
(the twin of ``tools/export_reference_checkpoint.py``):

    python -m codenerf_tpu_torch.export_reference_checkpoint \\
        <run_dir>/ckpt out/models.pth [--step N]

Writes the latest (or ``--step``) ``ckpt/step_*.pt`` that ``python -m
codenerf_tpu_torch.train`` saved through
``utils/checkpoint.save_reference_checkpoint``: the payload the reference
trainer saves (``src/trainer.py:165-174``), ``{model_params,
shape_code_params, texture_code_params, niter, nepoch}``, with the
reference layer names (``nn.Linear`` weights are already (out, in)) and
``niter`` the checkpoint's step. The network's widths are read from the
checkpoint. The JAX package's ``tools/convert_reference_checkpoint.py``
reads the result back, and so does the port's ``load_run`` for a run
directory that holds only ``models.pth``.

A checkpoint with a separate fine network (``hierarchical_share_weights:
false``) is refused: the reference layout has no slot for it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional


def export(ckpt_dir: str, out_pth: str, step: Optional[int] = None) -> str:
    from codenerf_tpu_torch.models.codenerf import CodeNeRF, state_dict_config
    from codenerf_tpu_torch.utils.checkpoint import (read_checkpoint,
                                                     save_reference_checkpoint)

    ck = read_checkpoint(ckpt_dir, step)
    if ck.get("fine_model") is not None:
        raise ValueError(
            f"{ckpt_dir}: the checkpoint holds a separate fine network "
            "(hierarchical_share_weights: false), and the reference "
            "models.pth has no slot for one; exporting it would drop the "
            "fine network, so the export is refused")
    sd = {k: v.float() for k, v in ck["model"].items()}
    model = CodeNeRF(state_dict_config(sd))
    model.load_state_dict(sd)
    niter = int(ck["step"])
    os.makedirs(os.path.dirname(os.path.abspath(out_pth)), exist_ok=True)
    save_reference_checkpoint(out_pth, model, ck["shape_codes"],
                              ck["texture_codes"], niter=niter)
    n = ck["shape_codes"].shape[0]
    print(f"exported {ckpt_dir} (step={niter}, {n} objects) -> {out_pth}")
    return out_pth


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Export a port checkpoint as a reference models.pth")
    ap.add_argument("ckpt_dir", help="port run ckpt dir (run_dir/ckpt)")
    ap.add_argument("out_pth", help="target models.pth path")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    return export(args.ckpt_dir, args.out_pth, args.step)


if __name__ == "__main__":
    main(sys.argv[1:])
