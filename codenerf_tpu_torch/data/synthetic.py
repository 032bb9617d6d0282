"""Synthetic multi-view datasets for tests, the quality report and the
smoke run; the port's own copy of ``codenerf_tpu/data/synthetic.py``.

Small, multi-view-consistent scenes rendered analytically with the
renderer's pinhole camera: one shaded sphere per object (per-object radius
and albedo), or a "chair" of boxes (seat, backrest, four thin legs). A
NeRF trained on them must learn 3D structure. The scene draws, the f64
numpy rendering and the uint8 quantization are the JAX package's, step for
step, so a seed gives the same bytes in both packages; the disk cache
(:func:`synthetic_scene_cached`) spells its keys the same way, so an entry
written by either package loads in the other. :func:`write_srn_layout`
writes a scene in the SRN directory layout (``src/data.py:10-37``).

The device renderers are the f32 transcription of the numpy ones in
PyTorch (:func:`make_view_fn`, JAX ``make_view_fn``): they render every
(object, view) pair of a full-scale split on the card
(``synthetic_scene(backend="device")``, :func:`_render_pairs`) and eval
ground truth from the generation parameters
(:func:`make_gt_view_renderer`). Their bytes differ from the numpy path's
only where f32 and f64 round to different sides of a uint8 level.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

_SRN_FLIP = np.diag(np.array([1.0, -1.0, -1.0, 1.0]))


def _look_at(cam_pos: np.ndarray, target: np.ndarray,
             up: np.ndarray) -> np.ndarray:
    """OpenGL-style c2w: camera -z looks at target. Columns [x, y, z | t]."""
    backward = cam_pos - target
    backward = backward / np.linalg.norm(backward)
    right = np.cross(up, backward)
    right = right / np.linalg.norm(right)
    true_up = np.cross(backward, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, true_up, backward
    c2w[:3, 3] = cam_pos
    return c2w


def _camera_dirs(H: int, W: int, focal: float, c2w: np.ndarray) -> np.ndarray:
    """(H, W, 3) unit world-space ray directions (``core/rays.py``'s
    convention), in f64."""
    v, u = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    dirs = np.stack(
        [(u - W * 0.5) / focal, -(v - H * 0.5) / focal, -np.ones_like(u)], -1
    )
    rays_d = dirs @ c2w[:3, :3].T
    return rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)


def _surface_pattern(shade: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Smooth world-anchored surface pattern. A plain shaded sphere is
    rotation-invariant, which makes camera pose unobservable along the
    orbit; pose-optimization scenes need texture to lock onto."""
    return shade * (0.75 + 0.25 * np.sin(5.0 * p[..., 0])
                    * np.sin(5.0 * p[..., 1]) * np.sin(5.0 * p[..., 2]))


def _render_sphere(
    H: int, W: int, focal: float, c2w: np.ndarray,
    radius: float, albedo: np.ndarray,
    pattern: bool = False,
) -> np.ndarray:
    """Analytic render of a lambertian-shaded sphere at the origin on a
    white background. Returns (H, W, 3) float32 in [0, 1]."""
    rays_d = _camera_dirs(H, W, focal, c2w)
    rays_o = c2w[:3, 3]

    # |o + t d|^2 = r^2  ->  t^2 + 2 t (o.d) + (|o|^2 - r^2) = 0
    b = np.sum(rays_o * rays_d, axis=-1)
    c = np.dot(rays_o, rays_o) - radius * radius
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0

    point = rays_o + t[..., None] * rays_d
    normal = point / max(radius, 1e-8)
    # Head-on lambert term keeps shading pose-consistent (light at camera).
    shade = np.clip(np.sum(normal * -rays_d, axis=-1), 0.2, 1.0)
    if pattern:
        shade = _surface_pattern(shade, point)
    img = np.ones((H, W, 3))
    img[hit] = albedo[None, :] * shade[hit][..., None]
    return img.astype(np.float32)


def _render_boxes(
    H: int, W: int, focal: float, c2w: np.ndarray,
    boxes: np.ndarray,   # (B, 2, 3): per box (center, half-extent)
    albedo: np.ndarray, yaw: float,
    pattern: bool = False,
) -> np.ndarray:
    """Analytic render of a union of axis-aligned boxes, rotated about z by
    ``yaw``, on a white background: slab-method intersection vectorized
    over pixels, the first hit over boxes in order, lambertian shading
    with the light at the camera and the normal of the entering face."""
    rays_d = _camera_dirs(H, W, focal, c2w)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)

    # Rotate rays into the object frame (object yaw about +z).
    cz, sz = np.cos(-yaw), np.sin(-yaw)
    rot = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    ro = rays_o @ rot.T          # (H, W, 3)
    rd = rays_d @ rot.T

    inv = 1.0 / np.where(np.abs(rd) < 1e-12, np.copysign(1e-12, rd), rd)
    best_t = np.full((H, W), np.inf)
    best_axis = np.zeros((H, W), dtype=np.int64)
    best_sign = np.zeros((H, W))
    for center, half in boxes:
        lo = (center - half - ro) * inv   # (H, W, 3)
        hi = (center + half - ro) * inv
        tmin = np.minimum(lo, hi)
        tmax = np.maximum(lo, hi)
        t0 = tmin.max(axis=-1)
        t1 = tmax.min(axis=-1)
        axis = tmin.argmax(axis=-1)
        hit = (t1 >= t0) & (t1 > 0.0) & (t0 > 1e-6) & (t0 < best_t)
        best_t = np.where(hit, t0, best_t)
        best_axis = np.where(hit, axis, best_axis)
        ax_dir = np.take_along_axis(rd, axis[..., None], axis=-1)[..., 0]
        best_sign = np.where(hit, -np.sign(ax_dir), best_sign)

    hit = np.isfinite(best_t)
    normal_obj = np.zeros((H, W, 3))
    np.put_along_axis(normal_obj, best_axis[..., None],
                      best_sign[..., None], axis=-1)
    shade = np.clip(np.sum(normal_obj * -rd, axis=-1), 0.2, 1.0)
    if pattern:
        p = ro + best_t[..., None] * rd
        shade = _surface_pattern(shade, np.where(hit[..., None], p, 0.0))
    img = np.ones((H, W, 3))
    img[hit] = albedo[None, :] * shade[hit][..., None]
    return img.astype(np.float32)


def _chair_boxes(rng: np.random.Generator) -> np.ndarray:
    """Randomized chair: seat slab + backrest slab + four thin legs, all
    inside a radius-~1.3 sphere around the origin."""
    seat_h = rng.uniform(-0.15, 0.05)          # seat top z
    sx = rng.uniform(0.38, 0.55)               # seat half-width (x)
    sy = rng.uniform(0.38, 0.55)               # seat half-depth (y)
    seat_t = rng.uniform(0.04, 0.08)           # seat half-thickness
    back_h = rng.uniform(0.5, 0.85)            # backrest height above seat
    back_t = rng.uniform(0.04, 0.08)           # backrest half-thickness
    leg_t = rng.uniform(0.035, 0.06)           # leg half-thickness
    leg_len = rng.uniform(0.5, 0.75)           # leg length below seat
    boxes = [
        # seat
        ([0.0, 0.0, seat_h - seat_t], [sx, sy, seat_t]),
        # backrest at -y edge
        ([0.0, -sy + back_t, seat_h + back_h / 2.0],
         [sx, back_t, back_h / 2.0]),
    ]
    lx, ly = sx - leg_t, sy - leg_t
    for dx in (-lx, lx):
        for dy in (-ly, ly):
            boxes.append(([dx, dy, seat_h - 2 * seat_t - leg_len / 2.0],
                          [leg_t, leg_t, leg_len / 2.0]))
    return np.array([(np.asarray(c, np.float64), np.asarray(h, np.float64))
                     for c, h in boxes])


def make_view_fn(H: int, W: int, pattern: bool, geometry: str,
                 device="cuda"):
    """The f32 transcription of :func:`_render_sphere` /
    :func:`_render_boxes` in PyTorch (JAX ``make_view_fn``,
    ``codenerf_tpu/data/synthetic.py:136-219``), batched over a leading
    pair axis.

    Returns ``fn(c2w, focal, albedo, *geom)``: ``c2w`` (P, 4, 4),
    ``focal`` (P,) or one value, ``albedo`` (P, 3) and ``geom`` ``(radius
    (P,),)`` for spheres or ``(boxes (P, B, 2, 3), yaw (P,))`` for chairs,
    all f32 tensors on ``device``; gives (P, H*W, 3) f32 in [0, 1] before
    quantization. Without the pair axis (``c2w`` (4, 4)) it gives (H*W,
    3). The 3×3 rotations are spelled as elementwise sums, so no matmul
    runs in TF32 wherever a caller enables it (TF32 flips pixels at hit
    edges)."""
    if geometry not in ("sphere", "chair"):
        raise ValueError(f"unknown geometry {geometry!r}")
    dev = torch.device(device)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    u = u.reshape(-1) - W * 0.5
    v = -(v.reshape(-1) - H * 0.5)

    def rays(c2w, focal):
        """(P, HW, 3) unit world directions: ``dirs_cam @ c2w[:3, :3].T``
        with ``dirs_cam = (u/f, v/f, -1)``."""
        x = u / focal[:, None]
        y = v / focal[:, None]
        r = c2w[:, :3, :3]
        rd = torch.stack([x * r[:, j, 0, None] + y * r[:, j, 1, None]
                          - r[:, j, 2, None] for j in range(3)], -1)
        return rd / torch.sqrt((rd * rd).sum(-1, keepdim=True))

    def compose(hit, shade_raw, point, albedo):
        shade = shade_raw.clamp(0.2, 1.0)
        if pattern:
            s = torch.sin(5.0 * torch.where(hit[..., None], point, 0.0))
            shade = shade * (0.75 + 0.25 * s[..., 0] * s[..., 1] * s[..., 2])
        return torch.where(hit[..., None],
                           albedo[:, None, :] * shade[..., None], 1.0)

    def sphere(c2w, focal, albedo, radius):
        rd = rays(c2w, focal)
        ro = c2w[:, :3, 3]
        b = (ro[:, None, :] * rd).sum(-1)
        c = (ro * ro).sum(-1) - radius * radius
        disc = b * b - c[:, None]
        t = -b - torch.sqrt(disc.clamp(min=0.0))
        hit = (disc > 0) & (t > 0)
        point = ro[:, None, :] + t[..., None] * rd
        normal = point / radius.clamp(min=1e-8)[:, None, None]
        return compose(hit, (normal * -rd).sum(-1), point, albedo)

    def chair(c2w, focal, albedo, boxes, yaw):
        rd_w = rays(c2w, focal)
        ro_w = c2w[:, :3, 3]
        # Into the object frame: ``@ rot.T`` with rot the yaw about +z.
        cz, sz = torch.cos(-yaw), torch.sin(-yaw)
        ro = torch.stack([ro_w[:, 0] * cz - ro_w[:, 1] * sz,
                          ro_w[:, 0] * sz + ro_w[:, 1] * cz, ro_w[:, 2]], -1)
        cz, sz = cz[:, None], sz[:, None]
        rd = torch.stack([rd_w[..., 0] * cz - rd_w[..., 1] * sz,
                          rd_w[..., 0] * sz + rd_w[..., 1] * cz,
                          rd_w[..., 2]], -1)
        tiny = torch.full_like(rd, 1e-12).copysign(rd)
        inv = 1.0 / torch.where(rd.abs() < 1e-12, tiny, rd)
        lo = boxes[:, :, 0] - boxes[:, :, 1]                 # (P, B, 3)
        hi = boxes[:, :, 0] + boxes[:, :, 1]
        a = (lo - ro[:, None])[:, None] * inv[:, :, None]    # (P, HW, B, 3)
        b2 = (hi - ro[:, None])[:, None] * inv[:, :, None]
        tmin = torch.minimum(a, b2)
        t0 = tmin.amax(-1)                                   # (P, HW, B)
        t1 = torch.maximum(a, b2).amin(-1)
        valid = (t1 >= t0) & (t1 > 0.0) & (t0 > 1e-6)
        t0v = torch.where(valid, t0, torch.inf)
        bi = t0v.argmin(-1, keepdim=True)     # the first box wins ties
        best_t = t0v.gather(-1, bi)[..., 0]
        hit = torch.isfinite(best_t)
        axis = tmin.argmax(-1).gather(-1, bi)                # (P, HW, 1)
        ax_dir = rd.gather(-1, axis)
        normal = (torch.nn.functional.one_hot(axis[..., 0], 3).to(rd.dtype)
                  * -torch.sign(ax_dir))
        tb = torch.where(hit, best_t, 0.0)    # no inf * 0 off the boxes
        point = ro[:, None, :] + tb[..., None] * rd
        return compose(hit, (normal * -rd).sum(-1), point, albedo)

    body = sphere if geometry == "sphere" else chair

    def view_fn(c2w, focal, albedo, *geom):
        if c2w.dim() == 2:
            return view_fn(c2w[None], focal.reshape(1), albedo[None],
                           *(g[None] for g in geom))[0]
        return body(c2w, focal.reshape(-1).expand(c2w.shape[0]), albedo,
                    *geom)

    return view_fn


def make_gt_view_renderer(H: int, W: int, pattern: bool, geometry: str,
                          device="cuda"):
    """Eval ground truth rendered on the device (JAX
    ``make_gt_view_renderer``, :222-244): ``fn(c2w, focal, params)`` with
    ``params`` a dict of ``albedo`` plus ``radius`` (sphere) or
    ``boxes``/``yaw`` (chair), the leaves of one object (or of P pairs,
    with the pair axis of :func:`make_view_fn`). Gives (H, W, 3) (or (P,
    H, W, 3)) f32 quantized as the stored images are, ``round(x · 255) /
    255``, so it equals what the uint8 image decodes to."""
    view_fn = make_view_fn(H, W, pattern, geometry, device)
    names = ("radius",) if geometry == "sphere" else ("boxes", "yaw")

    def gt_view(c2w, focal, params):
        rgb = view_fn(c2w, focal, params["albedo"],
                      *(params[k] for k in names))
        return (torch.round(rgb * 255.0) / 255.0).reshape(
            *rgb.shape[:-2], H, W, 3)

    return gt_view


def _pair_chunks(H: int, W: int, focal: float, c2w: np.ndarray,
                 albedo: np.ndarray, pattern: bool, geometry: str,
                 radius: Optional[np.ndarray] = None,
                 boxes: Optional[np.ndarray] = None,
                 yaw: Optional[np.ndarray] = None,
                 chunk_pairs: int = 2048, device="cuda"):
    """Yields ``(s, e, images)``: pairs ``s:e`` (at most ``chunk_pairs``)
    rendered and quantized on ``device``, (e - s, H, W, 3) uint8. Inner
    batches of at most 256 pairs (4M pixels) bound the device memory, as
    the JAX package's ``lax.map`` batches do."""
    dev = torch.device(device)
    view_fn = make_view_fn(H, W, pattern, geometry, dev)
    geom = (radius,) if geometry == "sphere" else (boxes, yaw)
    ops = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
           for x in (c2w, albedo) + geom]
    focal_t = torch.full((1,), float(np.float32(focal)), device=dev)
    inner = max(16, min(256, (1 << 22) // (H * W)))
    P = c2w.shape[0]
    for s in range(0, P, chunk_pairs):
        e = min(s + chunk_pairs, P)
        out = torch.empty((e - s, H * W, 3), dtype=torch.uint8, device=dev)
        for i in range(s, e, inner):
            j = min(i + inner, e)
            c, a, *g = (x[i:j] for x in ops)
            out[i - s:j - s] = torch.round(view_fn(c, focal_t, a, *g) * 255.0)
        yield s, e, out.reshape(e - s, H, W, 3)


def _render_pairs(H: int, W: int, focal: float, c2w: np.ndarray,
                  albedo: np.ndarray, pattern: bool, geometry: str,
                  radius: Optional[np.ndarray] = None,
                  boxes: Optional[np.ndarray] = None,
                  yaw: Optional[np.ndarray] = None,
                  chunk_pairs: int = 2048, device="cuda") -> np.ndarray:
    """Every (object, view) pair rendered on ``device`` (JAX
    ``_render_pairs_jax``, :247-300): ``c2w`` (P, 4, 4), ``albedo`` (P,
    3), ``radius`` (P,) or ``boxes`` (P, B, 2, 3) and ``yaw`` (P,), in one
    f32 pass per inner batch; gives (P, H, W, 3) uint8 on the host, copied
    in chunks of at most ``chunk_pairs`` pairs. From the card each chunk
    goes through one of two pinned staging buffers: its copy runs on the
    card while the host moves the previous chunk into the result."""
    P = c2w.shape[0]
    out = np.empty((P, H, W, 3), dtype=np.uint8)
    chunks = _pair_chunks(H, W, focal, c2w, albedo, pattern, geometry,
                          radius, boxes, yaw, chunk_pairs, device)
    if torch.device(device).type != "cuda":
        for s, e, images in chunks:
            out[s:e] = images.numpy()
        return out
    n = min(chunk_pairs, P) * H * W * 3
    stage = [torch.empty(n, dtype=torch.uint8, pin_memory=True)
             for _ in range(2)]
    pending = None

    def drain(s, e, buf, copied):
        copied.synchronize()
        out[s:e] = buf.numpy().reshape(e - s, H, W, 3)

    for k, (s, e, images) in enumerate(chunks):
        buf = stage[k % 2][:images.numel()]
        buf.copy_(images.reshape(-1), non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        if pending is not None:
            drain(*pending)
        pending = (s, e, buf, copied)
    if pending is not None:
        drain(*pending)
    return out


def _draws(n_objects: int, n_views: int, W: int, focal: Optional[float],
           cam_distance: float, seed: int, geometry: str) -> dict:
    """The scene's random draws in the JAX package's order: focal, radii,
    albedos, chairs (f64 boxes) and yaws, and each view's f64 ``c2w``."""
    rng = np.random.default_rng(seed)
    d = {"focal": focal if focal is not None else 1.2 * W,
         "radii": rng.uniform(0.7, 1.3, size=n_objects),
         "albedos": rng.uniform(0.1, 0.9, size=(n_objects, 3))}
    if geometry == "chair":
        d["chairs"] = np.stack([_chair_boxes(rng) for _ in range(n_objects)])
        d["yaws"] = rng.uniform(0.0, 2.0 * np.pi, size=n_objects)

    # Views on a tilted circle around the origin.
    azimuths = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    elevations = rng.uniform(0.15, 0.55, size=n_views)
    d["c2ws"] = np.zeros((n_views, 4, 4), dtype=np.float64)
    for vi, (az, el) in enumerate(zip(azimuths, elevations)):
        cam = cam_distance * np.array(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)]
        )
        d["c2ws"][vi] = _look_at(cam, np.zeros(3), np.array([0.0, 0.0, 1.0]))
    return d


def _pair_operands(d: dict, n_objects: int, n_views: int, geometry: str):
    """``(c2w, albedo, geom)`` of :func:`_render_pairs` for every pair of
    the draws ``d`` on one (object, view) axis: camera vi repeats per
    object and each object's parameters per view, the numpy loop's (oi,
    vi) at ``oi * n_views + vi``."""
    geom = ({"radius": np.repeat(d["radii"], n_views)}
            if geometry == "sphere" else
            {"boxes": np.repeat(d["chairs"], n_views, axis=0),
             "yaw": np.repeat(d["yaws"], n_views)})
    return (np.tile(d["c2ws"], (n_objects, 1, 1)),
            np.repeat(d["albedos"], n_views, axis=0), geom)


def _render_numpy(d: dict, H: int, W: int, pattern: bool, geometry: str,
                  oi: int, vi: int) -> np.ndarray:
    """Pair (oi, vi) of the draws ``d`` by the f64 numpy path, as uint8."""
    if geometry == "chair":
        img = _render_boxes(H, W, d["focal"], d["c2ws"][vi], d["chairs"][oi],
                            d["albedos"][oi], d["yaws"][oi], pattern=pattern)
    else:
        img = _render_sphere(H, W, d["focal"], d["c2ws"][vi], d["radii"][oi],
                             d["albedos"][oi], pattern=pattern)
    return np.round(img * 255.0).astype(np.uint8)


def numpy_pairs(pairs, n_objects: int = 3, n_views: int = 8, H: int = 32,
                W: int = 32, focal: Optional[float] = None,
                cam_distance: float = 4.0, seed: int = 0,
                pattern: bool = False, geometry: str = "sphere") -> np.ndarray:
    """The numpy backend's bytes of the (object, view) ``pairs`` of the
    scene that :func:`synthetic_scene` draws with these arguments, (len,
    H, W, 3) uint8, without rendering the other pairs: the reference a
    device-rendered full-scale split is sampled against."""
    d = _draws(n_objects, n_views, W, focal, cam_distance, seed, geometry)
    return np.stack([_render_numpy(d, H, W, pattern, geometry, oi, vi)
                     for oi, vi in pairs])


def synthetic_scene(
    n_objects: int = 3,
    n_views: int = 8,
    H: int = 32,
    W: int = 32,
    focal: Optional[float] = None,
    cam_distance: float = 4.0,
    seed: int = 0,
    pattern: bool = False,
    geometry: str = "sphere",
    backend: str = "numpy",
    params_only: bool = False,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """An in-memory multi-object scene: ``images`` (N, V, H, W, 3) uint8,
    ``poses`` (N, V, 4, 4) f32, ``focals`` (N,) f32 (the fields
    :class:`SRNDataset` exposes), suggested ``near``/``far`` bounds, and
    the generation parameters (``radii``/``albedos``, plus
    ``boxes``/``yaws`` for chairs, ``pattern``, ``geometry``).

    ``backend="numpy"`` renders each view in f64 on the host;
    ``backend="device"`` renders every (object, view) pair on ``device``
    (:func:`_render_pairs`; the JAX package's ``backend="jax"``) from the
    same draws, in f32, so a pixel may differ by one uint8 level at a
    quantization edge. ``params_only=True`` skips rendering and returns
    poses and parameters alone (the same draws, in the same order)."""
    if geometry not in ("sphere", "chair"):
        raise ValueError(f"unknown geometry {geometry!r}")
    if backend not in ("numpy", "device"):
        raise ValueError(
            f"unknown backend {backend!r}: the port renders with 'numpy' "
            "or on the card with 'device' (the JAX package's 'jax')")
    d = _draws(n_objects, n_views, W, focal, cam_distance, seed, geometry)
    focal = d["focal"]
    poses = np.zeros((n_objects, n_views, 4, 4), dtype=np.float32)
    poses[:] = d["c2ws"].astype(np.float32)[None]

    out = {
        "poses": poses,
        "focals": np.full((n_objects,), focal, dtype=np.float32),
        "H": H,
        "W": W,
        "near": float(cam_distance - 1.8),
        "far": float(cam_distance + 1.8),
        "radii": d["radii"],
        "albedos": d["albedos"],
        "pattern": pattern,
        "geometry": geometry,
    }
    if geometry == "chair":
        out["boxes"] = d["chairs"].astype(np.float32)  # (N, B, 2, 3)
        out["yaws"] = d["yaws"].astype(np.float32)
    if params_only:
        return out
    if backend == "device":
        from codenerf_tpu_torch import resolve_device

        c2w, albedo, geom = _pair_operands(d, n_objects, n_views, geometry)
        images = _render_pairs(
            H, W, focal, c2w, albedo, pattern, geometry,
            device=resolve_device(device), **geom,
        ).reshape(n_objects, n_views, H, W, 3)
        return {"images": images, **out}
    images = np.zeros((n_objects, n_views, H, W, 3), dtype=np.uint8)
    for vi in range(n_views):
        for oi in range(n_objects):
            images[oi, vi] = _render_numpy(d, H, W, pattern, geometry, oi, vi)
    return {"images": images, **out}


def synthetic_scene_cached(cache_dir: str, **kwargs) -> Dict[str, np.ndarray]:
    """:func:`synthetic_scene` with a disk cache keyed on the full
    generation parameter set (``<k>-<v>`` joined by ``_`` in key order,
    the JAX package's spelling). ``meta.npz`` is written last, so an
    interrupted write never half-loads; images load back memory-mapped."""
    key = "_".join(f"{k}-{kwargs[k]}" for k in sorted(kwargs))
    path = os.path.join(cache_dir, key)
    meta_path = os.path.join(path, "meta.npz")
    images_path = os.path.join(path, "images.npy")
    if not os.path.exists(meta_path):
        scene = synthetic_scene(**kwargs)
        os.makedirs(path, exist_ok=True)
        np.save(images_path, scene["images"])
        np.savez(meta_path,
                 **{k: v for k, v in scene.items() if k != "images"})
        scene["images"] = np.load(images_path, mmap_mode="r")
        return scene
    meta = np.load(meta_path)
    scene = {k: meta[k] for k in meta.files}
    for k in ("H", "W"):
        scene[k] = int(scene[k])
    for k in ("near", "far"):
        scene[k] = float(scene[k])
    if "geometry" in scene:   # newer entries carry generation params too
        scene["geometry"] = str(scene["geometry"])
        scene["pattern"] = bool(scene["pattern"])
    scene["images"] = np.load(images_path, mmap_mode="r")
    return scene


def write_srn_layout(root: str, scene: Dict[str, np.ndarray],
                     cat: str = "srn_cars", splits: str = "cars_train") -> str:
    """Write a scene in the SRN directory layout, poses stored with the
    inverse axis flip that the loader undoes (``src/data.py:12-16``).
    Returns the split directory."""
    from PIL import Image

    split_dir = os.path.join(root, cat, splits)
    n_objects, n_views, H, W = scene["images"].shape[:4]
    for oi in range(n_objects):
        obj_dir = os.path.join(split_dir, f"obj{oi:04d}")
        os.makedirs(os.path.join(obj_dir, "pose"), exist_ok=True)
        os.makedirs(os.path.join(obj_dir, "rgb"), exist_ok=True)
        with open(os.path.join(obj_dir, "intrinsics.txt"), "w") as f:
            focal = float(scene["focals"][oi])
            f.write(f"{focal} {W / 2.0} {H / 2.0} 0.\n0. 0. 0.\n1.\n{H} {W}\n")
        for vi in range(n_views):
            # loader computes disk_pose @ FLIP; FLIP is involutory.
            disk_pose = scene["poses"][oi, vi].astype(np.float64) @ _SRN_FLIP
            np.savetxt(
                os.path.join(obj_dir, "pose", f"{vi:06d}.txt"),
                disk_pose.reshape(1, 16),
            )
            Image.fromarray(scene["images"][oi, vi]).save(
                os.path.join(obj_dir, "rgb", f"{vi:06d}.png")
            )
    return split_dir
