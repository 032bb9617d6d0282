"""The port's se(3) exponential map (``codenerf_tpu_torch/core/poses.py``)
against ``codenerf_tpu/core/poses.py`` on seeded twists, the zero twist
and a rotation of 1e-7 (the Taylor branch) included.

Tolerances: the values within 1e-6 absolute (f32 transcendental functions
of the two libraries differ by an ulp or two on entries of size ~1); the
gradients of a seeded linear functional of ``exp_se3`` / ``refine_pose``
within 1e-5 relative plus 1e-6 absolute, and finite at ``xi = 0``, where
every pose optimization starts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.core import poses as j_poses
from codenerf_tpu_torch.core import poses


def _twist(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"zero": 0, "tiny": 1, "small": 2,
                                 "large": 3, "batch": 4}[kind])
    if kind == "zero":
        return np.zeros(6, np.float32)
    xi = rng.normal(size=(5, 6) if kind == "batch" else (6,))
    if kind == "tiny":      # |omega| = 1e-7: below the 1e-12 angle floor
        xi[:3] *= 1e-7 / np.linalg.norm(xi[:3])
    elif kind == "small":
        xi[:3] *= 1e-3 / np.linalg.norm(xi[:3])
    elif kind == "large":
        xi[:3] *= 2.5 / np.linalg.norm(xi[:3])
    return xi.astype(np.float32)


KINDS = ["zero", "tiny", "small", "large", "batch"]


@pytest.mark.parametrize("kind", KINDS)
def test_exp_maps_match_jax(kind):
    xi = _twist(kind)
    np.testing.assert_allclose(
        poses.exp_se3(torch.from_numpy(xi)).numpy(),
        np.asarray(j_poses.exp_se3(jnp.asarray(xi))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        poses.exp_so3(torch.from_numpy(xi[..., :3])).numpy(),
        np.asarray(j_poses.exp_so3(jnp.asarray(xi[..., :3]))), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_refine_pose_and_its_gradient_match_jax(kind):
    """``refine_pose`` and the gradient of ``Σ M ⊙ refine_pose(xi, c2w)``
    against ``jax.grad``; finite everywhere, the zero twist included."""
    xi = _twist(kind)
    rng = np.random.default_rng(7)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :4] = rng.normal(size=(3, 4))
    m = rng.normal(size=xi.shape[:-1] + (4, 4)).astype(np.float32)

    def j_obj(x):
        return jnp.sum(jnp.asarray(m) * j_poses.refine_pose(
            x, jnp.asarray(c2w)))

    want_g = np.asarray(jax.grad(j_obj)(jnp.asarray(xi)))
    x = torch.from_numpy(xi).requires_grad_(True)
    out = poses.refine_pose(x, torch.from_numpy(c2w))
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(j_poses.refine_pose(jnp.asarray(xi), jnp.asarray(c2w))),
        rtol=0, atol=1e-5)
    torch.sum(torch.from_numpy(m) * out).backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-5, atol=1e-6)


def test_exp_se3_is_a_rigid_transform():
    xi = torch.from_numpy(_twist("batch"))
    T = poses.exp_se3(xi)
    R = T[..., :3, :3]
    eye = torch.eye(3).expand_as(R)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(T[..., 3, :].numpy(),
                                  np.broadcast_to([0, 0, 0, 1], (5, 4)))
    torch.testing.assert_close(poses.exp_se3(torch.zeros(6)), torch.eye(4))
