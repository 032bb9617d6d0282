"""The reference's served render: one image of an object's codes from an
orbit camera, through the plain model, to the clipped uint8 image.

Deterministic sampling: ``N_samples`` depths evenly spaced over
``[near, far]`` (``src/utils.py:21-32`` without the jitter), the composite
on white, the colour times 255 clipped to [0, 255] and cut to uint8.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import codenerf as ref


def orbit_c2w(azimuth: float, elevation: float, radius: float) -> np.ndarray:
    """OpenGL camera-to-world (4, 4) on a sphere looking at the origin,
    +z up, worked out in float64 and stored in float32."""
    cam = radius * np.array([np.cos(azimuth) * np.cos(elevation),
                             np.sin(azimuth) * np.cos(elevation),
                             np.sin(elevation)])
    back = cam / np.linalg.norm(cam)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(back, right), back
    c2w[:3, 3] = cam
    return c2w.astype(np.float32)


@torch.no_grad()
def render(p: dict, hp: dict, shape_code: torch.Tensor,
           texture_code: torch.Tensor, c2w: np.ndarray, H: int, W: int,
           focal: float, precision: str = "f32",
           chunk: int = 4096) -> np.ndarray:
    """(H, W, 3) uint8."""
    ref.set_exact_float32()
    prec = ref.Precision(precision)
    dev = shape_code.device
    c2w_t = torch.from_numpy(c2w).to(dev)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], -1)
    focal_t = torch.full((H * W,), float(np.float32(focal)), device=dev)
    ro, vd = ref.pixel_rays(uv, focal_t, c2w_t.expand(H * W, 4, 4), H, W)
    S = hp["N_samples"]
    z = torch.linspace(hp["near"], hp["far"], S, device=dev)
    out = []
    for s in range(0, H * W, chunk):
        o, d = ro[s:s + chunk], vd[s:s + chunk]
        n = o.shape[0]
        zz = z.expand(n, S)
        sigma, rgb = ref.forward(p, hp["net_hyperparams"],
                                 o[:, None] + d[:, None] * zz[..., None], d,
                                 shape_code.expand(n, -1),
                                 texture_code.expand(n, -1), prec)
        out.append(ref.composite(sigma, rgb, zz)[0])
    img = torch.cat(out).reshape(H, W, 3)
    return np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
