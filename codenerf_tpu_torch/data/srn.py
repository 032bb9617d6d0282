"""ShapeNet-SRN dataset loader (reference ``src/data.py:10-89``); the
port's own copy of ``codenerf_tpu/data/srn.py``.

    <data_dir>/<cat>/<splits>/<obj_id>/
        pose/*.txt         # 16 floats, row-major 4x4 camera-to-world
        rgb/*.png          # H x W color images
        intrinsics.txt     # line 1: "f cx cy ..."; last line: "H W"

Poses are right-multiplied by ``diag(1, -1, -1, 1)`` (SRN -> OpenGL axes);
images stay uint8; object ids and view files are sorted.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

_SRN_FLIP = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float64))


def load_pose(path: str) -> np.ndarray:
    pose = np.loadtxt(path).reshape(4, 4)
    return (pose @ _SRN_FLIP).astype(np.float32)


def load_intrinsics(path: str) -> Tuple[float, int, int]:
    with open(path, "r") as f:
        lines = f.readlines()
    focal = float(lines[0].split()[0])
    H, W = lines[-1].split()
    return focal, int(H), int(W)


def _load_image_u8(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _sorted_files(d: str) -> list:
    return sorted(os.path.join(d, f.name) for f in os.scandir(d))


class SRNDataset:
    """An SRN category split in host memory: ``ids`` (N,), ``images``
    (N, V, H, W, 3) uint8, ``poses`` (N, V, 4, 4) float32, ``focals`` (N,)."""

    def __init__(self, cat: str = "srn_cars", splits: str = "cars_train",
                 data_dir: str = "data/ShapeNet_SRN",
                 max_objects: Optional[int] = None):
        self.root = os.path.join(data_dir, cat, splits)
        self.ids = sorted(f.name for f in os.scandir(self.root) if f.is_dir())
        if max_objects is not None:
            self.ids = self.ids[:max_objects]
        if not self.ids:
            raise FileNotFoundError(f"No objects under {self.root}")

        def load_object(obj_id):
            obj_dir = os.path.join(self.root, obj_id)
            pose_files = _sorted_files(os.path.join(obj_dir, "pose"))
            img_files = _sorted_files(os.path.join(obj_dir, "rgb"))
            focal, h, w = load_intrinsics(
                os.path.join(obj_dir, "intrinsics.txt"))
            poses = np.stack([load_pose(p) for p in pose_files])
            images = np.stack([_load_image_u8(p) for p in img_files])
            return focal, h, w, poses, images

        # PNG decoding releases the GIL, so threads overlap it.
        with ThreadPoolExecutor(max_workers=8) as ex:
            loaded = list(ex.map(load_object, self.ids))

        H = W = None
        images, poses, focals = [], [], []
        for obj_id, (focal, h, w, p, im) in zip(self.ids, loaded):
            if H is None:
                H, W = h, w
            elif (H, W) != (h, w):
                raise ValueError(f"Inconsistent image size in split: {obj_id} "
                                 f"is {h}x{w}, expected {H}x{W}")
            poses.append(p)
            images.append(im)
            focals.append(focal)
        self.poses = np.stack(poses)
        self.images = np.stack(images)
        self.focals = np.asarray(focals, dtype=np.float32)
        self.H, self.W = int(H), int(W)

    @property
    def n_objects(self) -> int:
        return len(self.ids)

    @property
    def n_views(self) -> int:
        return self.images.shape[1]
