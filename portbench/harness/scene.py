"""The benchmark's scenes: seeded car-like objects rendered on the device.

A frozen copy of the port's device box renderer
(``codenerf_tpu_torch/data/synthetic.py::make_view_fn``, its ray-box
slab test, Lambert shading and world-anchored pattern), with a car's
boxes in place of a chair's: a body, a cabin on it and four wheels, yawed
about +z, inside the 0.55-radius ball that SRN cars' near/far of 0.8/1.8
around a camera at 1.3 frames. Every object has its own 50 cameras on the
upper half of that sphere, looking at the origin, as SRN cars' training
views do. All draws come from one generator on the device, so a seed
gives the same images on the same card; the images live in host memory
only and are never written to disk.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _u(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def draw_objects(spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Per object ``albedo`` (N, 3), ``boxes`` (N, 6, 2, 3) (centre,
    half-size), ``yaw`` (N,); per view ``c2w`` (N, V, 4, 4)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    N, V = spec["n_objects"], spec["n_views"]
    u = lambda shape, lo, hi: _u(gen, shape, lo, hi, device)  # noqa: E731
    hx, hy, hz = u(N, 0.36, 0.45), u(N, 0.15, 0.21), u(N, 0.07, 0.11)
    bz = u(N, -0.12, -0.04)
    cx, cy, cz = hx * u(N, 0.45, 0.65), hy * u(N, 0.8, 0.95), u(N, 0.06, 0.1)
    off = u(N, -0.1, 0.05)
    zero = torch.zeros(N, device=device)
    boxes = [((zero, zero, bz), (hx, hy, hz)),
             ((off, zero, bz + hz + cz), (cx, cy, cz))]
    wheel = (torch.full((N,), 0.07, device=device),
             torch.full((N,), 0.03, device=device),
             torch.full((N,), 0.07, device=device))
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            boxes.append(((sx * (hx - 0.1), sy * hy, bz - hz), wheel))
    boxes = torch.stack([torch.stack([torch.stack(c, -1), torch.stack(h, -1)],
                                     -2) for c, h in boxes], 1)
    az = u((N, V), 0.0, 2.0 * math.pi)
    el = u((N, V), 0.1, 0.6)
    r = spec["cam_radius"]
    cam = torch.stack([r * torch.cos(az) * torch.cos(el),
                       r * torch.sin(az) * torch.cos(el),
                       r * torch.sin(el)], -1)
    return {"albedo": u((N, 3), 0.1, 0.9), "boxes": boxes,
            "yaw": u(N, 0.0, 2.0 * math.pi), "c2w": look_at(cam)}


def look_at(cam: torch.Tensor) -> torch.Tensor:
    """OpenGL camera-to-world matrices (..., 4, 4) of cameras at ``cam``
    looking at the origin, +z up."""
    back = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    up = torch.zeros_like(cam)
    up[..., 2] = 1.0
    right = torch.linalg.cross(up, back, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    true_up = torch.linalg.cross(back, right, dim=-1)
    c2w = torch.zeros(*cam.shape[:-1], 4, 4, device=cam.device)
    c2w[..., :3, 0], c2w[..., :3, 1], c2w[..., :3, 2] = right, true_up, back
    c2w[..., :3, 3] = cam
    c2w[..., 3, 3] = 1.0
    return c2w


def render_views(c2w, focal: float, albedo, boxes, yaw, H: int,
                 W: int) -> torch.Tensor:
    """(P, H*W, 3) f32 in [0, 1] of P (camera, object) pairs on white."""
    dev = c2w.device
    v, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                           torch.arange(W, dtype=torch.float32, device=dev),
                           indexing="ij")
    x = (uu.reshape(-1) - W * 0.5) / focal
    y = -(v.reshape(-1) - H * 0.5) / focal
    r = c2w[:, :3, :3]
    rd = torch.stack([x * r[:, j, 0, None] + y * r[:, j, 1, None]
                      - r[:, j, 2, None] for j in range(3)], -1)
    rd = rd / torch.sqrt((rd * rd).sum(-1, keepdim=True))
    ro_w = c2w[:, :3, 3]
    cz, sz = torch.cos(-yaw), torch.sin(-yaw)
    ro = torch.stack([ro_w[:, 0] * cz - ro_w[:, 1] * sz,
                      ro_w[:, 0] * sz + ro_w[:, 1] * cz, ro_w[:, 2]], -1)
    cz, sz = cz[:, None], sz[:, None]
    rd = torch.stack([rd[..., 0] * cz - rd[..., 1] * sz,
                      rd[..., 0] * sz + rd[..., 1] * cz, rd[..., 2]], -1)
    tiny = torch.full_like(rd, 1e-12).copysign(rd)
    inv = 1.0 / torch.where(rd.abs() < 1e-12, tiny, rd)
    lo = boxes[:, :, 0] - boxes[:, :, 1]
    hi = boxes[:, :, 0] + boxes[:, :, 1]
    a = (lo - ro[:, None])[:, None] * inv[:, :, None]
    b = (hi - ro[:, None])[:, None] * inv[:, :, None]
    tmin = torch.minimum(a, b)
    t0 = tmin.amax(-1)
    t1 = torch.maximum(a, b).amin(-1)
    valid = (t1 >= t0) & (t1 > 0.0) & (t0 > 1e-6)
    t0v = torch.where(valid, t0, torch.inf)
    bi = t0v.argmin(-1, keepdim=True)
    best = t0v.gather(-1, bi)[..., 0]
    hit = torch.isfinite(best)
    axis = tmin.argmax(-1).gather(-1, bi)
    normal = (torch.nn.functional.one_hot(axis[..., 0], 3).to(rd.dtype)
              * -torch.sign(rd.gather(-1, axis)))
    point = ro[:, None, :] + torch.where(hit, best, 0.0)[..., None] * rd
    shade = (normal * -rd).sum(-1).clamp(0.2, 1.0)
    s = torch.sin(5.0 * torch.where(hit[..., None], point, 0.0))
    shade = shade * (0.75 + 0.25 * s[..., 0] * s[..., 1] * s[..., 2])
    return torch.where(hit[..., None], albedo[:, None, :] * shade[..., None],
                       1.0)


def make_scene(spec: dict, seed: int, device) -> dict:
    """``images`` (N, V, H, W, 3) uint8 on the host, ``poses`` (N, V, 4, 4)
    and ``focals`` (N,) f32 numpy, and the same poses and focals as
    tensors on ``device`` (``poses_t``, ``focals_t``)."""
    dev = torch.device(device)
    d = draw_objects(spec, seed, dev)
    N, V, H, W = spec["n_objects"], spec["n_views"], spec["H"], spec["W"]
    focal = float(spec["focal"])
    c2w = d["c2w"].reshape(N * V, 4, 4)
    albedo, boxes, yaw = (x.repeat_interleave(V, 0)
                          for x in (d["albedo"], d["boxes"], d["yaw"]))
    P = N * V
    images = np.empty((P, H, W, 3), dtype=np.uint8)
    inner = max(1, (1 << 21) // (H * W))
    chunk = max(inner, 2048 // inner * inner)
    stage = ([torch.empty(chunk * H * W * 3, dtype=torch.uint8,
                          pin_memory=True) for _ in range(2)]
             if dev.type == "cuda" else None)
    pending = None
    for k, s in enumerate(range(0, P, chunk)):
        e = min(s + chunk, P)
        out = torch.empty((e - s, H * W, 3), dtype=torch.uint8, device=dev)
        for i in range(s, e, inner):
            j = min(i + inner, e)
            out[i - s:j - s] = torch.round(render_views(
                c2w[i:j], focal, albedo[i:j], boxes[i:j], yaw[i:j], H,
                W) * 255.0)
        if stage is None:
            images[s:e] = out.reshape(e - s, H, W, 3).numpy()
            continue
        buf = stage[k % 2][:out.numel()]
        buf.copy_(out.reshape(-1), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        if pending is not None:
            _drain(images, *pending, H, W)
        pending = (s, e, buf, done)
    if pending is not None:
        _drain(images, *pending, H, W)
    poses = d["c2w"]
    focals = torch.full((N,), focal, device=dev)
    return {"images": images.reshape(N, V, H, W, 3),
            "poses": poses.cpu().numpy(), "focals": focals.cpu().numpy(),
            "poses_t": poses, "focals_t": focals}


def _drain(images, s, e, buf, done, H, W):
    done.synchronize()
    images[s:e] = buf.numpy().reshape(e - s, H, W, 3)
