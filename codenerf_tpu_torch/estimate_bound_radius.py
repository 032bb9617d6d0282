"""Estimate a bounding-sphere radius for ``bound_sphere_radius`` from a
trained run (the twin of ``tools/estimate_bound_radius.py``): render depth
and opacity from a few orbit views, back-project the opaque ray
terminations to 3D, and report a high quantile of their distance from the
origin (SRN objects are origin-normalized):

    python -m codenerf_tpu_torch.estimate_bound_radius --saved_dir <run> \\
        --jsonfile srncar.json [--obj 0 --H 64 --W 64] [--device cuda]

The run is read through ``utils/checkpoint.load_run``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def estimate_radius(model, hp, poses, focal, H, W, codes,
                    n_views: int = 4, opacity_thresh: float = 0.5,
                    quantile: float = 0.995, margin: float = 1.1) -> float:
    """The largest over the views of the ``quantile`` distance from the
    origin of the rays' termination points whose opacity exceeds
    ``opacity_thresh``, times ``margin``. Each view renders whole (one
    ``render_rays`` call, deterministic depths) through the plain module,
    as the JAX tool does."""
    import torch

    from codenerf_tpu_torch.config import resolve_dtype
    from codenerf_tpu_torch.core.rays import camera_rays
    from codenerf_tpu_torch.renderer import render_rays

    shape_code, texture_code = codes
    dev = shape_code.device
    radii = []
    for v in range(min(n_views, poses.shape[0])):
        ro, vd = camera_rays(H, W, focal, torch.as_tensor(poses[v]),
                             device=dev)
        with torch.no_grad():
            res = render_rays(model, hp.render, ro, vd, shape_code,
                              texture_code, None,
                              compute_dtype=resolve_dtype(hp.compute_dtype))
        acc = res.final.acc.cpu().numpy()
        depth = res.final.depth.cpu().numpy()
        hit = acc > opacity_thresh
        if not hit.any():
            continue
        pts = ro.cpu().numpy()[hit] + depth[hit, None] * vd.cpu().numpy()[hit]
        radii.append(np.quantile(np.linalg.norm(pts, axis=-1), quantile))
    if not radii:
        raise RuntimeError("no opaque rays found — model untrained?")
    return float(np.max(radii) * margin)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Estimate bound_sphere_radius (PyTorch)")
    ap.add_argument("--saved_dir", type=str, required=True)
    ap.add_argument("--jsonfile", type=str, default="srncar.json")
    ap.add_argument("--exps_root", type=str, default="exps")
    ap.add_argument("--obj", type=int, default=0)
    ap.add_argument("--H", type=int, default=64)
    ap.add_argument("--W", type=int, default=64)
    ap.add_argument("--focal", type=float, default=None)
    ap.add_argument("--radius_cam", type=float, default=1.3,
                    help="camera orbit radius used for probe views")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)

    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.render_orbit import orbit_pose
    from codenerf_tpu_torch.utils.checkpoint import load_run

    device = resolve_device(args.device)
    hp = load_hparams(args.jsonfile)
    model, _, sc, tc = load_run(os.path.join(args.exps_root, args.saved_dir),
                                hp, device)
    poses = np.stack([orbit_pose(a, 0.35, args.radius_cam)
                      for a in np.linspace(0, 2 * np.pi, 4, endpoint=False)])
    focal = args.focal or 1.1 * args.W
    r = estimate_radius(model, hp, poses, focal, args.H, args.W,
                        (sc[args.obj].to(device), tc[args.obj].to(device)))
    print(f"estimated bound_sphere_radius: {r:.3f}")
    print(f'add to your jsonfile: "bound_sphere_radius": {r:.3f}')
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
