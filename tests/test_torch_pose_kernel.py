"""The single-pass kernel's pose modes in the port (plain PyTorch version,
on the CPU) against the JAX package's ``invoke_train_fused(
weight_grads=False, input_grads=True[, want_weights=True])`` in Pallas
interpret mode, on the same seeded operands; and ``FusedPoseLoss``
chained through the per-ray prologue against the JAX recipe of
``tests/test_fused_train.py::test_single_pass_input_grads_vs_autodiff``.

Tolerances, each with its reason:

- the kernel outputs: both versions round to bf16 at the same points and
  differ by f32 summation order, which flips an occasional bf16 rounding
  of an activation or a cotangent. The bar of
  ``tests/test_torch_fused_train.py``: relative L2 below 5e-3, each
  element within 1e-2 of the largest magnitude plus 5e-3 relative; the
  SE at rtol 1e-4; the weights plane (an f32 composite of bf16-rounded
  sigmas) at 1e-4 absolute;
- the gradients of the rays, depths and codes through the prologue:
  relative L2 below 1e-2 each (the bar of ``tests/test_torch_hier.py``
  for a kernel chained through a prologue that rounds to bf16); against
  the f32 autodiff gradient, at least as close as the XLA bf16 path is
  (``rel_port <= 1.5·rel_xla + 1e-3``, the JAX test's own bar).
"""

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

torch.set_num_threads(2)     # W=256 on the CPU: keep xdist workers apart


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched, raising=True)


R, S = 32, 16
KW = dict(shape_blocks=2, texture_blocks=1, W=256)
SCALE = 1.0 / (R * 3.0)


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


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def setup():
    """W=256 weights in both packages and seeded rays, depths, codes and
    ground truth."""
    jcfg = JNetConfig(**KW)
    jparams = init_codenerf(jax.random.PRNGKey(0), jcfg)
    cfg = NetConfig(**KW)
    model = CodeNeRF(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    rng = np.random.default_rng(11)
    ro = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.3, 2.2, (R, S)).astype(np.float32), axis=-1)
    sc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg,
                model=model.requires_grad_(False), ro=ro, vd=vd, z=z, sc=sc,
                tc=tc, gt=gt)


def _operands(k):
    ops = j_fused_mlp.prep_ray_operands(
        k["jparams"], k["jcfg"], jnp.asarray(k["ro"]), jnp.asarray(k["vd"]),
        jnp.asarray(k["z"]), jnp.asarray(k["sc"]), jnp.asarray(k["tc"]))
    gt8 = j_fused_mlp._pad_lanes(jnp.asarray(k["gt"]), 8)
    ro8, vd8, zj, sproj, tproj, vcontrib = ops
    targs = (k["cfg"], S, R, True, SCALE, _t(ro8), _t(vd8), _t(zj),
             _t(sproj, torch.bfloat16), _t(tproj, torch.bfloat16),
             _t(vcontrib, torch.bfloat16), _t(gt8),
             fused_train.flatten_params(k["model"], k["cfg"]))
    return ops, gt8, targs


@pytest.mark.parametrize("want_weights", [False, True])
def test_plain_pose_modes_match_jax_kernel(setup, want_weights):
    """Every output of the pose modes: the SE, the code cotangents, the
    weights plane, ``d_ro8``, ``d_vd8`` and ``d_z``."""
    k = setup
    ops, gt8, targs = _operands(k)
    kw = dict(weight_grads=False, input_grads=True,
              want_weights=want_weights)
    want = j_ft.invoke_train_fused(
        k["jcfg"], S, R, True, SCALE, *ops, gt8,
        j_ft.flatten_params_f32(k["jparams"], k["jcfg"]), **kw)
    got = fused_train.train_fused_plain(*targs, **kw)
    names = (["d_sproj", "d_tproj", "d_vcontrib"]
             + ["weights"] * want_weights + ["d_ro8", "d_vd8", "d_z"])
    assert len(got) == len(want) == 1 + len(names)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    for g, w, name in zip(got[1:], want[1:], names):
        assert tuple(g.shape) == tuple(w.shape), name
        if name == "weights":
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4, err_msg=name)
        else:
            _close(g.float().numpy(), w, name)
    d_ro8, d_vd8 = got[-3], got[-2]
    assert not d_ro8[:, 3:].any() and not d_vd8[:, 3:].any()
    # the wrapper takes the plain version on CPU tensors, launching nothing
    before = dict(fused_train.train_fused.launches)
    again = fused_train.train_fused(*targs, **kw)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert fused_train.train_fused.launches == before


def test_pose_mode_appends_to_the_codes_mode(setup):
    """The pose modes only add to the frozen mode's chain: on the same
    inputs the SE, the code cotangents and the composited rows are the
    same bits, and the weights plane sums to the composited opacity."""
    _, _, targs = _operands(setup)
    codes = fused_train.train_fused_plain(*targs, weight_grads=False,
                                          want_rgb=True)
    pose = fused_train.train_fused_plain(*targs, weight_grads=False,
                                         want_weights=True, want_rgb=True,
                                         input_grads=True)
    for a, b in zip(pose[:4] + pose[5:6], codes):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    np.testing.assert_allclose(pose[4].sum(1).numpy(), pose[5][:, 4].numpy(),
                               rtol=1e-5)    # acc = Σ w


def test_mode_checks():
    """The pose modes' counters, and those of the input gradients with
    weight gradients, which are ported too (their outputs against JAX:
    tests/test_torch_train_pairs.py): every flag pair passes the check."""
    for kw in ({"want_weights": True, "input_grads": True},
               {"input_grads": True}):
        for wg in (False, True):
            fused_train._check_mode(wg, kw.get("want_weights", False),
                                    kw["input_grads"], None, None)
    assert fused_train._mode(False, False, True, True) == "pose_weights"
    assert fused_train._mode(False, False, False, True) == "pose"
    assert fused_train._mode(True, False, False, True) == "train_input"
    assert fused_train._mode(True, False, True, True) == \
        "train_input_weights"
    assert {"pose", "pose_weights", "train_input", "train_input_weights"} \
        <= set(fused_train.train_fused.launches)


def _jax_sp_grads(k, ro, vd, z, sc, tc):
    """The JAX recipe: one vjp over ``prep_ray_operands`` chained with the
    pose mode's six cotangents."""
    jcfg, jparams = k["jcfg"], k["jparams"]
    gt8 = j_fused_mlp._pad_lanes(jnp.asarray(k["gt"]), 8)
    wflat = [jax.lax.stop_gradient(w)
             for w in j_ft.flatten_params_f32(jparams, jcfg)]

    def prologue(ro, vd, z, sc, tc):
        return j_fused_mlp.prep_ray_operands(jparams, jcfg, ro, vd, z, sc,
                                             tc)

    ops6, pvjp = jax.vjp(prologue, ro, vd, z, sc, tc)
    outs = j_ft.invoke_train_fused(jcfg, S, R, True, SCALE, *ops6, gt8,
                                   wflat, weight_grads=False,
                                   input_grads=True)
    se, d_sproj, d_tproj, d_vcontrib, d_ro8, d_vd8, d_z = outs
    return se, pvjp((d_ro8, d_vd8, d_z, d_sproj, d_tproj, d_vcontrib))


def _port_grads(k):
    leaves = [torch.from_numpy(k[n]).requires_grad_(True)
              for n in ("ro", "vd", "z", "sc", "tc")]
    ro8, vd8, z, sproj, tproj, vcontrib = fused_mlp.prep_ray_operands(
        k["model"], k["cfg"], *leaves)
    wops = fused_train.kernel_operands(fused_train.flatten_params(
        k["model"], k["cfg"]))
    loss, fine, w = fused_train.FusedPoseLoss.apply(
        ro8, vd8, z, sproj, tproj, vcontrib, k["cfg"], True, SCALE,
        fused_mlp.pad_lanes(_t(k["gt"]), 8), wops, False)
    assert w.numel() == 0 and not fine.requires_grad
    loss.backward()
    return loss.detach(), [x.grad for x in leaves]


def test_fused_pose_loss_chain_matches_jax_recipe(setup):
    k = setup
    se, g_want = _jax_sp_grads(k, *(jnp.asarray(k[n]) for n in
                                    ("ro", "vd", "z", "sc", "tc")))
    loss, g_got = _port_grads(k)
    np.testing.assert_allclose(float(loss), float(se) * SCALE, rtol=1e-4)
    for name, g, w in zip(["ro", "vd", "z", "shape", "texture"], g_got,
                          g_want):
        assert torch.isfinite(g).all(), name
        assert _rel(g.numpy(), w) < 1e-2, (name, _rel(g.numpy(), w))


def test_pose_gradients_vs_f32_autodiff(setup):
    """The port's chain is at least as close to ``jax.grad`` of the plain
    f32 model as the XLA bf16 path: d_z in particular sums the
    composite's own z term with the xyz/PE Jacobian chain."""
    k = setup
    jcfg, jparams = k["jcfg"], k["jparams"]
    sc, tc, gt = (jnp.asarray(k[n]) for n in ("sc", "tc", "gt"))

    def xla_loss(dtype):
        def loss(ro, vd, z):
            xyz = ro[:, None, :] + vd[:, None, :] * z[..., None]
            s, r = apply_codenerf(
                jparams, jcfg, xyz, vd,
                jnp.broadcast_to(sc, (R, jcfg.latent_dim)),
                jnp.broadcast_to(tc, (R, jcfg.latent_dim)),
                compute_dtype=dtype)
            res = j_composite(s, r, z, white_bg=True)
            return jnp.sum((res.rgb - gt) ** 2) * SCALE
        return loss

    args = tuple(jnp.asarray(k[n]) for n in ("ro", "vd", "z"))
    g32 = jax.grad(xla_loss(jnp.float32), (0, 1, 2))(*args)
    g16 = jax.grad(xla_loss(jnp.bfloat16), (0, 1, 2))(*args)
    _, g_got = _port_grads(k)
    for name, a32, a16, got in zip(["ro", "vd", "z"], g32, g16, g_got):
        rel_xla, rel_port = _rel(a16, a32), _rel(got.numpy(), a32)
        assert rel_port <= 1.5 * rel_xla + 1e-3, (name, rel_port, rel_xla)
