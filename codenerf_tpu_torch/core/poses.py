"""Differentiable camera-pose parameterization: the se(3) exponential map
(counterpart of ``codenerf_tpu/core/poses.py``).

A pose refinement is a 6-vector ``xi = (omega, t)`` applied as
``c2w' = exp(xi) @ c2w``, differentiable end to end through ray
generation (``optimization/pose_opt.py``). Closed-form Rodrigues and
left-Jacobian coefficients. Near ``theta = 0`` the double-``where``
pattern keeps the backward finite: the squared angle is clamped away
from zero before the square root, so neither branch of the select makes
a NaN (``torch.where``, like a single ``jnp.where``, still
back-propagates NaN from the branch it did not select). Every pose
optimization starts at ``xi = 0``.
"""

from __future__ import annotations

import torch

_EPS2 = 1e-12


def _hat(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(ox)
    return torch.stack([torch.stack([zeros, -oz, oy], dim=-1),
                        torch.stack([oz, zeros, -ox], dim=-1),
                        torch.stack([-oy, ox, zeros], dim=-1)], dim=-2)


def _sincos_coeffs(omega: torch.Tensor):
    """``(a, b, c) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3)``,
    each (..., 1, 1), with Taylor branches below ``t^2 < 1e-12``."""
    t2_raw = torch.sum(omega * omega, dim=-1, keepdim=True)[..., None]
    small = t2_raw < _EPS2
    t2 = torch.where(small, torch.ones_like(t2_raw), t2_raw)  # before sqrt
    theta = torch.sqrt(t2)
    a = torch.where(small, 1.0 - t2_raw / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2_raw / 24.0, (1.0 - torch.cos(theta)) / t2)
    c = torch.where(small, 1.0 / 6.0 - t2_raw / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    return a, b, c


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation: (..., 3) axis-angle -> (..., 3, 3)."""
    a, b, _ = _sincos_coeffs(omega)
    K = _hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * K + b * (K @ K)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (..., 6) twist (omega, t) -> (..., 4, 4)."""
    omega, t = xi[..., :3], xi[..., 3:]
    a, b, c = _sincos_coeffs(omega)
    K = _hat(omega)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    trans = torch.einsum("...ij,...j->...i", V, t)
    top = torch.cat([R, trans[..., None]], dim=-1)
    # [0 0 0 1], made on the device (a tensor from Python numbers would
    # be a host-to-device copy, which synchronizes the stream)
    bottom = torch.nn.functional.pad(
        torch.ones(*top.shape[:-2], 1, 1, dtype=xi.dtype, device=xi.device),
        (3, 0))
    return torch.cat([top, bottom], dim=-2)


def refine_pose(xi: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """``exp(xi) @ c2w``: xi (..., 6), c2w (..., 4, 4) -> (..., 4, 4)."""
    return exp_se3(xi) @ c2w
