"""Synthetic multi-view datasets for tests, the quality report and the
smoke run; the port's own copy of ``codenerf_tpu/data/synthetic.py``'s
numpy path.

Small, multi-view-consistent scenes rendered analytically with the
renderer's pinhole camera: one shaded sphere per object (per-object radius
and albedo), or a "chair" of boxes (seat, backrest, four thin legs). A
NeRF trained on them must learn 3D structure. The scene draws, the f64
numpy rendering and the uint8 quantization are the JAX package's, step for
step, so a seed gives the same bytes in both packages; the disk cache
(:func:`synthetic_scene_cached`) spells its keys the same way, so an entry
written by either package loads in the other. :func:`write_srn_layout`
writes a scene in the SRN directory layout (``src/data.py:10-37``).

The JAX package's device renderers (``backend="jax"``, ``make_view_fn``,
``make_gt_view_renderer``) have no port yet (ROADMAP.md Queue 1, item
13b): any backend but ``"numpy"`` raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

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
) -> Dict[str, np.ndarray]:
    """An in-memory multi-object scene: ``images`` (N, V, H, W, 3) uint8,
    ``poses`` (N, V, 4, 4) f32, ``focals`` (N,) f32 (the fields
    :class:`SRNDataset` exposes), suggested ``near``/``far`` bounds, and
    the generation parameters (``radii``/``albedos``, plus
    ``boxes``/``yaws`` for chairs, ``pattern``, ``geometry``).

    ``params_only=True`` skips rendering and returns poses and parameters
    alone (the draws are the same, in the same order). Only
    ``backend="numpy"`` is ported: the JAX package's device backend
    raises here (ROADMAP.md Queue 1, item 13b) rather than quietly
    rendering something else."""
    if geometry not in ("sphere", "chair"):
        raise ValueError(f"unknown geometry {geometry!r}")
    if backend != "numpy":
        raise NotImplementedError(
            f"synthetic_scene backend={backend!r}: the device renderers are "
            "not ported yet (ROADMAP.md Queue 1, item 13b); use "
            "backend='numpy'")
    rng = np.random.default_rng(seed)
    focal = focal if focal is not None else 1.2 * W
    radii = rng.uniform(0.7, 1.3, size=n_objects)
    albedos = rng.uniform(0.1, 0.9, size=(n_objects, 3))
    if geometry == "chair":
        chairs = [_chair_boxes(rng) for _ in range(n_objects)]
        yaws = rng.uniform(0.0, 2.0 * np.pi, size=n_objects)

    # Views on a tilted circle around the origin.
    azimuths = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    elevations = rng.uniform(0.15, 0.55, size=n_views)

    poses = np.zeros((n_objects, n_views, 4, 4), dtype=np.float32)
    c2ws = np.zeros((n_views, 4, 4), dtype=np.float64)
    for vi, (az, el) in enumerate(zip(azimuths, elevations)):
        cam = cam_distance * np.array(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)]
        )
        c2ws[vi] = _look_at(cam, np.zeros(3), np.array([0.0, 0.0, 1.0]))
        poses[:, vi] = c2ws[vi].astype(np.float32)

    out = {
        "poses": poses,
        "focals": np.full((n_objects,), focal, dtype=np.float32),
        "H": H,
        "W": W,
        "near": float(cam_distance - 1.8),
        "far": float(cam_distance + 1.8),
        "radii": radii,
        "albedos": albedos,
        "pattern": pattern,
        "geometry": geometry,
    }
    if geometry == "chair":
        out["boxes"] = np.stack(chairs).astype(np.float32)  # (N, B, 2, 3)
        out["yaws"] = yaws.astype(np.float32)
    if params_only:
        return out
    images = np.zeros((n_objects, n_views, H, W, 3), dtype=np.uint8)
    for vi in range(n_views):
        c2w = c2ws[vi]
        for oi in range(n_objects):
            if geometry == "chair":
                img = _render_boxes(H, W, focal, c2w, chairs[oi],
                                    albedos[oi], yaws[oi], pattern=pattern)
            else:
                img = _render_sphere(H, W, focal, c2w, radii[oi],
                                     albedos[oi], pattern=pattern)
            images[oi, vi] = np.round(img * 255.0).astype(np.uint8)
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
