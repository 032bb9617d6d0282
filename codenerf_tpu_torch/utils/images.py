"""Image helpers (reference ``src/utils.py:49-71``): min-max rescaling to
uint8 (not clipping), the [generated | ground truth] grid, PNG writes and
the argparse boolean parser."""

from __future__ import annotations

import argparse

import numpy as np


def image_float_to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    vmin, vmax = float(np.min(img)), float(np.max(img))
    if vmax - vmin < 1e-10:
        vmax += 1e-10
    return ((img - vmin) / (vmax - vmin) * 255.0).astype(np.uint8)


def side_by_side(generated: np.ndarray, ground_truth: np.ndarray) -> np.ndarray:
    """[generated | ground truth] uint8 grid; (H, W, 3) or stacked
    (N, H, W, 3) inputs, rows concatenated vertically."""
    generated = np.asarray(generated)
    ground_truth = np.asarray(ground_truth)
    if generated.ndim == 3:
        generated, ground_truth = generated[None], ground_truth[None]
    rows = np.concatenate([generated, ground_truth], axis=2)
    return image_float_to_uint8(rows.reshape(-1, rows.shape[2], 3))


def save_png(path: str, img_u8: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img_u8).save(path)


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "1"):
        return True
    if v.lower() in ("no", "false", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")
