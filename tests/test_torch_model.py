"""The port's ``CodeNeRF`` module against ``apply_codenerf`` on the same
weights, and weight interchange through the reference ``models.pth``.

Tolerances: both sides evaluate the same graph and, in bf16 compute, round
each layer's matmul output to bf16 before the bias add and after the ReLU.
Over four seeds they differ by at most 1.2e-7 in either dtype. The bar is
1e-5 in float32 (summation order) and 1e-3 in bf16, room for one flipped
bf16 rounding (one ulp, 3.9e-3 relative, on an activation) on outputs of
order 0.1."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.models.codenerf import apply_codenerf, init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.utils.checkpoint import load_reference_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from export_reference_checkpoint import trainables_to_reference  # noqa: E402

KW = dict(shape_blocks=2, texture_blocks=1, W=128, num_xyz_freq=6,
          num_dir_freq=2, latent_dim=32)


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, init_codenerf(jax.random.PRNGKey(0), JNetConfig(**KW)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
@pytest.mark.parametrize("per_ray_codes", [False, True])
def test_forward_matches_apply_codenerf(dtype, tol, per_ray_codes):
    params = _jax_params()
    model = CodeNeRF(NetConfig(**KW)).requires_grad_(False)
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(0)
    R, S = 6, 10
    xyz = rng.uniform(-1, 1, (R, S, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    shape = (R, 32) if per_ray_codes else (32,)
    sc = (rng.normal(size=shape) * 0.3).astype(np.float32)
    tc = (rng.normal(size=shape) * 0.3).astype(np.float32)
    sig, rgb = model(torch.from_numpy(xyz), torch.from_numpy(vd),
                     torch.from_numpy(sc), torch.from_numpy(tc),
                     compute_dtype=getattr(torch, dtype))
    jsig, jrgb = apply_codenerf(params, JNetConfig(**KW), jnp.asarray(xyz),
                                jnp.asarray(vd), jnp.asarray(sc),
                                jnp.asarray(tc),
                                compute_dtype=getattr(jnp, dtype))
    assert sig.shape == (R, S) and rgb.shape == (R, S, 3)
    assert sig.dtype == rgb.dtype == torch.float32
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=tol,
                               atol=tol)


def test_models_pth_round_trip(tmp_path):
    """JAX trainables -> tools/export_reference_checkpoint -> models.pth ->
    the port: weights and code tables arrive unchanged."""
    params = _jax_params()
    trainables = {
        "params": params,
        "shape_codes": np.asarray(init_codes(jax.random.PRNGKey(1), 5, 32)),
        "texture_codes": np.asarray(init_codes(jax.random.PRNGKey(2), 5, 32)),
    }
    path = tmp_path / "models.pth"
    torch.save(trainables_to_reference(trainables, niter=7), path)
    state, shape_codes, texture_codes = load_reference_checkpoint(str(path))
    model = CodeNeRF(NetConfig(**KW))
    model.load_state_dict(state)
    for key, want in params_from_jax(params).items():
        np.testing.assert_array_equal(model.state_dict()[key].numpy(),
                                      want.numpy(), err_msg=key)
    np.testing.assert_array_equal(shape_codes.numpy(),
                                  trainables["shape_codes"])
    np.testing.assert_array_equal(texture_codes.numpy(),
                                  trainables["texture_codes"])


def test_seeded_init_matches_torch_linear_distribution():
    """Layer names, shapes and the nn.Linear U(-1/sqrt(fan_in), +) range
    of ``init_codenerf``; the same generator seed gives the same weights."""
    cfg = NetConfig(**KW)
    a = CodeNeRF(cfg, generator=torch.Generator().manual_seed(3))
    b = CodeNeRF(cfg, generator=torch.Generator().manual_seed(3))
    a.requires_grad_(False)
    params = _jax_params()
    assert {k.split(".")[0] for k in a.state_dict()} == set(params)
    for name, layer in params.items():
        lin = getattr(a, name)
        assert tuple(lin.weight.shape) == layer["w"].T.shape
        bound = 1.0 / np.sqrt(layer["w"].shape[0])
        assert float(lin.weight.abs().max()) <= bound
        assert torch.equal(lin.weight, getattr(b, name).weight)
