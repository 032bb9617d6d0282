"""The port's single-pass kernel (plain PyTorch version, on the CPU) against
the JAX package's ``invoke_train_fused(weight_grads=False, want_rgb=True)``
run in Pallas interpret mode, on the same seeded inputs.

Tolerances: the plain version rounds to bf16 exactly where the TPU kernel
does, so the two differ only by f32 summation order (and the composite's
cumprod against the TPU's log-space matmul), which flips an occasional bf16
rounding. Measured over three seeds, that leaves the bf16 cotangents
within 2.4e-3 relative L2 error and 5.2e-3 of their largest magnitude
elementwise (a bf16 ulp is 3.9e-3 relative, and a per-ray sum over many
samples that nearly cancels keeps the absolute error of its terms). The
bar: relative L2 error below 5e-3, and elementwise 1e-2 of the largest
magnitude plus 5e-3 relative. The f32 loss sum gets rtol 1e-4; the
composited rows 1e-4 absolute, since one flipped bf16 activation moves a
ray's color by ~2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.core.render import composite as j_composite
from codenerf_tpu.models.codenerf import apply_codenerf, init_codenerf
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import fused_mlp, fused_train


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched, raising=True)


R, S = 32, 24
KW = dict(shape_blocks=2, texture_blocks=1, W=256)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.3, 2.2, (R, S)).astype(np.float32), axis=-1)
    sc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    return ro, vd, z, sc, tc, gt


def _models():
    jcfg = JNetConfig(**KW)
    jparams = init_codenerf(jax.random.PRNGKey(0), jcfg)
    model = CodeNeRF(NetConfig(**KW))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    return jcfg, jparams, model.requires_grad_(False)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _close(got, want, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    assert top > 0, name
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 5e-3, (name, rel_l2)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-2 * top,
                               err_msg=name)


def test_plain_kernel_matches_jax_train_kernel():
    jcfg, jparams, model = _models()
    cfg = NetConfig(**KW)
    ro, vd, z, sc, tc, gt = _inputs()
    ro8, vd8, zj, sproj, tproj, vcontrib = j_fused_mlp.prep_ray_operands(
        jparams, jcfg, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(sc), jnp.asarray(tc))
    gt8 = j_fused_mlp._pad_lanes(jnp.asarray(gt), 8)
    scale = 1.0 / (R * 3.0)
    want = j_ft.invoke_train_fused(
        jcfg, S, R, True, scale, ro8, vd8, zj, sproj, tproj, vcontrib, gt8,
        j_ft.flatten_params_f32(jparams, jcfg), want_rgb=True,
        weight_grads=False)

    wflat = fused_train.flatten_params(model, cfg)
    for a, b in zip(wflat, j_ft.flatten_params_f32(jparams, jcfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fused_train.train_fused(
        cfg, S, R, True, scale, _t(ro8), _t(vd8), _t(zj),
        _t(sproj, torch.bfloat16), _t(tproj, torch.bfloat16),
        _t(vcontrib, torch.bfloat16), _t(gt8), wflat, want_rgb=True,
        weight_grads=False)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-3, atol=1e-4, err_msg="rgb8")
    for g, w, name in zip(got[1:4], want[1:4],
                          ["d_sproj", "d_tproj", "d_vcontrib"]):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), w, name)


@pytest.mark.parametrize("mode", ["dual", "want_weights", "input_grads"])
def test_unported_modes_raise(mode):
    cfg = NetConfig(**KW)
    kw = {"want_weights": mode == "want_weights",
          "input_grads": mode == "input_grads",
          "coarse_mask": torch.ones(R, S) if mode == "dual" else None}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fused_train.train_fused(cfg, S, R, True, 1.0, *([None] * 8), **kw)


def test_other_devices_raise():
    """Only CPU tensors take the plain version; a tensor elsewhere (here the
    meta device) never silently falls back to it."""
    cfg = NetConfig(**KW)
    z = torch.empty(R, S, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_train.train_fused(cfg, S, R, True, 1.0, z, z, z, z, z, z, z,
                                [], weight_grads=False)


def test_codes_gradient_through_prologue_matches_jax_grad():
    """Prologue + kernel (autograd.Function) codes gradient against
    ``jax.grad`` of the plain XLA loss in f32: at least as close to it as
    the XLA bf16 path is (the bar of ``test_fused_codes_op_grads``)."""
    jcfg, jparams, model = _models()
    cfg = NetConfig(**KW)
    ro, vd, z, sc, tc, gt = _inputs(seed=5)
    scale = 1.0 / (R * 3.0)

    def xla_loss(dtype):
        def loss(s, t):
            xyz = jnp.asarray(ro)[:, None] + jnp.asarray(vd)[:, None] * \
                jnp.asarray(z)[..., None]
            sig, rgb = apply_codenerf(jparams, jcfg, xyz, jnp.asarray(vd),
                                      s, t, compute_dtype=dtype)
            res = j_composite(sig, rgb, jnp.asarray(z), white_bg=True)
            return jnp.sum((res.rgb - jnp.asarray(gt)) ** 2) * scale
        return loss

    scode = torch.tensor(sc, requires_grad=True)
    tcode = torch.tensor(tc, requires_grad=True)
    ro8, vd8, zt, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
        model, cfg, _t(ro), _t(vd), _t(z), scode, tcode)
    wops = fused_train.kernel_operands(fused_train.flatten_params(model, cfg))
    loss, _ = fused_train.FusedCodesLoss.apply(
        sproj, tproj, vcontrib, cfg, True, scale, ro8, vd8, zt,
        fused_mlp.pad_lanes(_t(gt), 8), wops, False)
    loss.backward()

    l32 = float(xla_loss(jnp.float32)(jnp.asarray(sc), jnp.asarray(tc)))
    assert abs(loss.item() - l32) < 2e-3 * max(1.0, abs(l32))
    g32 = jax.grad(xla_loss(jnp.float32), (0, 1))(jnp.asarray(sc),
                                                  jnp.asarray(tc))
    g16 = jax.grad(xla_loss(jnp.bfloat16), (0, 1))(jnp.asarray(sc),
                                                   jnp.asarray(tc))
    for name, a32, a16, got in zip(["shape", "texture"], g32, g16,
                                   [scode.grad, tcode.grad]):
        v32 = np.asarray(a32, np.float32)
        rel_xla = np.linalg.norm(np.asarray(a16, np.float32) - v32) / (
            np.linalg.norm(v32) + 1e-12)
        rel_port = np.linalg.norm(got.numpy() - v32) / (
            np.linalg.norm(v32) + 1e-12)
        assert rel_port <= rel_xla * 1.5 + 1e-3, (name, rel_port, rel_xla)
