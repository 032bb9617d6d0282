"""Turntable orbit renders of a trained object (the twin of
``tools/render_orbit.py``):

    python -m codenerf_tpu_torch.render_orbit --saved_dir <run> \\
        --jsonfile srncar.json [--obj 0 --n_frames 60 --out DIR] \\
        [--elevation 0.3 --radius 1.3] [--device cuda]

Reads the run through ``utils/checkpoint.load_run`` (the latest
``<run>/ckpt/step_*.pt``, else ``<run>/models.pth``; the fine network
with separate fine weights). Codes come from the training tables
(``--obj`` row) or from an optimize run's ``codes.npz`` (``--codes path
--obj i``). Each frame renders deterministically through
``renderer.render_image`` (on the card the forward kernels where they
take the render, else the plain module(s)), is clipped ×255 to uint8 and
written as ``frame_%03d.png``; then ``orbit.gif`` (PIL).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def orbit_pose(azimuth: float, elevation: float, radius: float) -> np.ndarray:
    """OpenGL-style c2w on a sphere looking at the origin (z-up)."""
    cam = radius * np.array([
        np.cos(azimuth) * np.cos(elevation),
        np.sin(azimuth) * np.cos(elevation),
        np.sin(elevation),
    ])
    backward = cam / np.linalg.norm(cam)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, backward)
    right /= np.linalg.norm(right)
    true_up = np.cross(backward, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (right, true_up,
                                                      backward, cam)
    return c2w.astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Orbit renders (PyTorch)")
    ap.add_argument("--saved_dir", type=str, required=True)
    ap.add_argument("--jsonfile", type=str, default="srncar.json")
    ap.add_argument("--exps_root", type=str, default="exps")
    ap.add_argument("--obj", type=int, default=0)
    ap.add_argument("--codes", type=str, default=None,
                    help="optional codes.npz from optimize")
    ap.add_argument("--n_frames", type=int, default=60)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--W", type=int, default=128)
    ap.add_argument("--focal", type=float, default=None)
    ap.add_argument("--radius", type=float, default=1.3)
    ap.add_argument("--elevation", type=float, default=0.3)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def main(argv=None) -> str:
    """Run the CLI; returns the output directory."""
    args = build_parser().parse_args(argv)

    import torch

    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.config import load_hparams, resolve_dtype
    from codenerf_tpu_torch.renderer import render_image
    from codenerf_tpu_torch.utils.checkpoint import load_run
    from codenerf_tpu_torch.utils.images import save_png

    device = resolve_device(args.device)
    hp = load_hparams(args.jsonfile)
    run_dir = os.path.join(args.exps_root, args.saved_dir)
    model, fine_model, shape_codes, texture_codes = load_run(run_dir, hp,
                                                             device)
    if args.codes:
        codes = np.load(args.codes)
        shape_code = torch.from_numpy(
            codes["optimized_shapecodes"][args.obj]).float()
        texture_code = torch.from_numpy(
            codes["optimized_texturecodes"][args.obj]).float()
    else:
        shape_code, texture_code = (shape_codes[args.obj],
                                    texture_codes[args.obj])
    shape_code, texture_code = shape_code.to(device), texture_code.to(device)

    out_dir = args.out or os.path.join(run_dir, f"orbit_obj{args.obj}")
    os.makedirs(out_dir, exist_ok=True)
    focal = args.focal if args.focal else 1.1 * args.W
    chunk = min(4096, args.H * args.W)

    frames = []
    for i in range(args.n_frames):
        az = 2.0 * np.pi * i / args.n_frames
        img = render_image(
            model, hp.render, args.H, args.W, focal,
            torch.from_numpy(orbit_pose(az, args.elevation, args.radius)).to(
                device), shape_code, texture_code, None, chunk=chunk,
            compute_dtype=resolve_dtype(hp.compute_dtype),
            fine_model=fine_model).cpu().numpy()
        u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        save_png(os.path.join(out_dir, f"frame_{i:03d}.png"), u8)
        frames.append(u8)
        print(f"frame {i + 1}/{args.n_frames}", end="\r", flush=True)

    from PIL import Image

    gif = [Image.fromarray(f) for f in frames]
    gif[0].save(os.path.join(out_dir, "orbit.gif"), save_all=True,
                append_images=gif[1:], duration=50, loop=0)
    print(f"\nwrote {args.n_frames} frames + orbit.gif -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1:])
