"""Shape/texture editing CLI of the port (the twin of ``tools/edit.py``):

    python -m codenerf_tpu_torch.edit --saved_dir <run> \\
        --jsonfile srncar.json --objects 0 1 2 --grid 5 --view 0 \\
        [--device cuda]

Operates on the trained code tables of a run, read through
``utils/checkpoint.load_run`` (the latest ``<run>/ckpt/step_*.pt``, else
``<run>/models.pth``; the fine network with separate fine weights):
because CodeNeRF disentangles shape and texture, edits are renders under
interpolated or swapped codes (``optimization/editing.py``). The dataset
supplies only the camera (pose, focal, H, W of ``--view`` of the first
object) and the ground truth the swap matrix's diagonal is scored on.

Writes under ``<exps_root>/<saved_dir>/edits[_N]/``:
  shape_interp.png    object A's shape morphing into B's, texture fixed
  texture_interp.png  texture morph, shape fixed
  swap_matrix.png     full shape x texture cross product over --objects
  results.json        swap-matrix diagonal PSNR vs dataset GT
The PNGs are min-max scaled (``utils/images.image_float_to_uint8``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _unique_dir(base: str) -> str:
    path, num = base, 2
    while os.path.isdir(path):
        path = f"{base}_{num}"
        num += 1
    os.makedirs(path)
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Latent-code editing: interpolation strips + swap matrix")
    ap.add_argument("--saved_dir", type=str, default="default")
    ap.add_argument("--jsonfile", type=str, default="srncar.json")
    ap.add_argument("--exps_root", type=str, default="exps")
    ap.add_argument("--objects", type=int, nargs="+", default=[0, 1],
                    help="TRAIN object indices whose checkpointed codes to "
                    "edit (first two define the interpolation endpoints; "
                    "all of them span the swap matrix)")
    ap.add_argument("--grid", type=int, default=5,
                    help="interpolation steps (endpoints included)")
    ap.add_argument("--view", type=int, default=0,
                    help="camera view (of the first object) to render from")
    ap.add_argument("--batchsize", type=int, default=4096)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns the output directory, the swap matrix (Gs, Gt,
    H, W, 3) and the diagonal's PSNR by object id."""
    args = build_parser().parse_args(argv)
    if len(args.objects) < 2:
        raise SystemExit("--objects needs at least two train object indices")

    import torch

    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.data.srn import SRNDataset
    from codenerf_tpu_torch.optimization.editing import (
        interpolate_codes, render_code_grid, render_shape_texture_matrix)
    from codenerf_tpu_torch.utils.checkpoint import load_run
    from codenerf_tpu_torch.utils.images import image_float_to_uint8, save_png

    device = resolve_device(args.device)
    hp = load_hparams(args.jsonfile)
    run_dir = os.path.join(args.exps_root, args.saved_dir)
    model, fine_model, shape_codes, texture_codes = load_run(run_dir, hp,
                                                             device)
    save_dir = _unique_dir(os.path.join(run_dir, "edits"))
    print("we are going to save at", save_dir)

    # Codes were trained on the TRAIN split in dataset order.
    ds = SRNDataset(cat=hp.data.cat, splits=hp.data.splits,
                    data_dir=hp.data.data_dir,
                    max_objects=max(args.objects) + 1)
    n_codes = shape_codes.shape[0]
    bad = [i for i in args.objects if i >= n_codes]
    if bad:
        raise SystemExit(f"--objects {bad} out of range: the checkpoint "
                         f"holds {n_codes} trained code rows")
    shape_codes, texture_codes = shape_codes.to(device), texture_codes.to(
        device)

    a, b = args.objects[0], args.objects[1]
    H, W = ds.images.shape[2:4]
    c2w = torch.from_numpy(np.asarray(ds.poses[a, args.view],
                                      np.float32)).to(device)
    focal = float(ds.focals[a])
    chunk = min(args.batchsize, H * W)
    G = args.grid
    kw = dict(chunk=chunk, fine_model=fine_model)

    s_interp = interpolate_codes(shape_codes[a], shape_codes[b], G)
    t_interp = interpolate_codes(texture_codes[a], texture_codes[b], G)
    t_fixed = texture_codes[a].expand(G, texture_codes.shape[1])
    s_fixed = shape_codes[a].expand(G, shape_codes.shape[1])
    strip_shape = render_code_grid(model, hp, s_interp, t_fixed, H, W, focal,
                                   c2w, **kw).cpu().numpy()
    strip_tex = render_code_grid(model, hp, s_fixed, t_interp, H, W, focal,
                                 c2w, **kw).cpu().numpy()
    save_png(os.path.join(save_dir, "shape_interp.png"),
             image_float_to_uint8(np.concatenate(strip_shape, axis=1)))
    save_png(os.path.join(save_dir, "texture_interp.png"),
             image_float_to_uint8(np.concatenate(strip_tex, axis=1)))

    sel = torch.as_tensor(args.objects, device=device)
    mat = render_shape_texture_matrix(
        model, hp, shape_codes[sel], texture_codes[sel], H, W, focal, c2w,
        **kw).cpu().numpy()
    rows = [np.concatenate(list(mat[i]), axis=1) for i in range(mat.shape[0])]
    save_png(os.path.join(save_dir, "swap_matrix.png"),
             image_float_to_uint8(np.concatenate(rows, axis=0)))

    # Identity-edit fidelity: the matrix diagonal (object i's shape with its
    # own texture) rendered from object a's camera against each object's
    # own GT view — meaningful when the camera is shared across objects
    # (SRN-layout categories: the same orbit per split).
    diag_psnr = {}
    for j, oi in enumerate(args.objects):
        gt = ds.images[oi, args.view].astype(np.float32) / 255.0
        mse = float(np.mean((mat[j, j] - gt) ** 2))
        diag_psnr[ds.ids[oi]] = -10.0 * float(np.log10(max(mse, 1e-12)))
    with open(os.path.join(save_dir, "results.json"), "w") as f:
        json.dump({"args": vars(args), "diag_psnr": diag_psnr,
                   "mean_diag_psnr": float(np.mean(list(diag_psnr.values())))},
                  f, indent=2)
    print("swap-matrix diagonal vs GT: "
          + ", ".join(f"{k}: {v:.2f}" for k, v in diag_psnr.items())
          + f" dB (mean {np.mean(list(diag_psnr.values())):.2f})")
    print(f"wrote {save_dir}/shape_interp.png, texture_interp.png, "
          "swap_matrix.png")
    return {"save_dir": save_dir, "matrix": mat, "diag_psnr": diag_psnr}


if __name__ == "__main__":
    main(sys.argv[1:])
