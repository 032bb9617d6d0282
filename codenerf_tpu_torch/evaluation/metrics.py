"""Image-quality metrics (counterpart of
``codenerf_tpu/evaluation/metrics.py``).

PSNR is ``-10·log10(mse)`` over float [0, 1] images. SSIM follows
skimage's ``structural_similarity`` as the reference calls it: 7×7 uniform
window, K1=0.01, K2=0.03, unbiased covariance, (win-1)/2 border crop, mean
over channels — and ``data_range`` defaults to 2.0, the range skimage
assumes for float images when the reference omits it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_WIN = 7
_K1 = 0.01
_K2 = 0.03


def psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def reference_psnr_mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - gt.float()) ** 2)


def _uniform_filter_valid(x: torch.Tensor) -> torch.Tensor:
    """7×7 mean over VALID windows of (C, H, W) -> (C, H-6, W-6)."""
    s = F.avg_pool2d(x[:, None], _WIN, stride=1, divisor_override=1)[:, 0]
    return s / float(_WIN * _WIN)


def ssim(img0: torch.Tensor, img1: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Mean SSIM of two (H, W, 3) or (H, W) float images."""
    x, y = img0.float(), img1.float()
    if x.dim() == 2:
        x, y = x[..., None], y[..., None]
    x, y = x.permute(2, 0, 1), y.permute(2, 0, 1)       # (C, H, W)
    n = float(_WIN * _WIN)
    cov_norm = n / (n - 1.0)
    ux, uy = _uniform_filter_valid(x), _uniform_filter_valid(y)
    uxx = _uniform_filter_valid(x * x)
    uyy = _uniform_filter_valid(y * y)
    uxy = _uniform_filter_valid(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2
    a1, a2 = 2.0 * ux * uy + c1, 2.0 * vxy + c2
    b1, b2 = ux * ux + uy * uy + c1, vx + vy + c2
    return ((a1 * a2) / (b1 * b2)).mean(dim=(1, 2)).mean()
