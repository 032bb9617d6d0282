"""The single-pass kernel's two flag pairs that no path calls, in the port
(plain PyTorch version, on the CPU) against the JAX package's
``invoke_train_fused`` in Pallas interpret mode on the same seeded
operands, as ``tests/test_fused_train.py`` runs the JAX kernel:
``input_grads`` with weight gradients (the dW/db and the ray and depth
cotangents from one pass) and ``want_weights`` without ``input_grads``
(the weights plane beside the code cotangents and the dW/db, the JAX
package's former two-call hierarchical training route).

Tolerances, each with its reason: both versions round to bf16 at the same
points and differ by f32 summation order, which flips an occasional bf16
rounding. The bar of ``tests/test_torch_fused_train.py`` for every
cotangent and dW/db (relative L2 below 5e-3; each element within 1e-2 of
the largest magnitude plus 5e-3 relative), whose elementwise scale for
the sigma head's cancelling sums ``Σ t·dsig`` and ``Σ dsig`` is the sum
of their terms' magnitudes (``tests/test_torch_train_step.py``); the SE
at rtol 1e-4; the weights plane (an f32 composite of bf16-rounded sigmas)
at 1e-4 absolute (``tests/test_torch_pose_kernel.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import fused_train

torch.set_num_threads(2)     # W=256 on the CPU: keep xdist workers apart


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
SCALE = 1.0 / (R * 3.0)
PAIRS = {"train_input": dict(weight_grads=True, input_grads=True),
         "train_weights": dict(weight_grads=True, want_weights=True)}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _close(got, want, name, terms=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if terms is None:
        top = float(np.abs(want).max())
        assert top > 0, name
        rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel_l2 < 5e-3, (name, rel_l2)
    else:
        top = float(np.max(terms))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-2 * top,
                               err_msg=name)


@pytest.fixture(scope="module")
def setup():
    jcfg = JNetConfig(**KW)
    jparams = init_codenerf(jax.random.PRNGKey(0), jcfg)
    cfg = NetConfig(**KW)
    model = CodeNeRF(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    rng = np.random.default_rng(5)
    ro = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.3, 2.2, (R, S)).astype(np.float32), axis=-1)
    sc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    ops = j_fused_mlp.prep_ray_operands(
        jparams, jcfg, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(sc), jnp.asarray(tc))
    gt8 = j_fused_mlp._pad_lanes(jnp.asarray(gt), 8)
    ro8, vd8, zj, sproj, tproj, vcontrib = ops
    targs = (cfg, S, R, True, SCALE, _t(ro8), _t(vd8), _t(zj),
             _t(sproj, torch.bfloat16), _t(tproj, torch.bfloat16),
             _t(vcontrib, torch.bfloat16), _t(gt8),
             fused_train.flatten_params(model.requires_grad_(False), cfg))
    jargs = (jcfg, S, R, True, SCALE, *ops, gt8,
             j_ft.flatten_params_f32(jparams, jcfg))
    return cfg, jargs, targs


@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_pair_matches_jax_kernel(setup, pair):
    """Every output of the pair, in the JAX kernel's order: the SE, the
    code cotangents, [the weights plane], [d_ro8, d_vd8, d_z], every
    dW/db."""
    cfg, jargs, targs = setup
    kw = PAIRS[pair]
    want = j_ft.invoke_train_fused(*jargs, **kw)
    sigma_terms = []
    got = fused_train.train_fused_plain(*targs, sigma_terms=sigma_terms, **kw)
    names = (["d_sproj", "d_tproj", "d_vcontrib"]
             + ["weights"] * kw.get("want_weights", False)
             + ["d_ro8", "d_vd8", "d_z"] * kw.get("input_grads", False)
             + [f"{n}.{k}" for n, _, _ in fused_train.weight_shapes(cfg)
                for k in ("w", "b")])
    terms = dict(zip(["sigma.w", "sigma.b"],
                     [x.numpy() for x in sigma_terms]))
    assert len(got) == len(want) == 1 + len(names)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    for g, w, name in zip(got[1:], want[1:], names):
        assert tuple(g.shape) == tuple(w.shape), name
        if name == "weights":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4, err_msg=name)
        else:
            _close(g.float().numpy(), w, name, terms.get(name))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_pair_extends_the_training_mode(setup, pair):
    """The pair only adds outputs to the weight-gradient mode: on the
    same inputs the SE, the code cotangents and every dW/db are that
    mode's, bit for bit; the wrapper takes the plain version on CPU
    tensors and launches nothing."""
    cfg, _, targs = setup
    kw = PAIRS[pair]
    base = fused_train.train_fused(*targs, weight_grads=True)
    before = dict(fused_train.train_fused.launches)
    got = fused_train.train_fused(*targs, **kw)
    assert fused_train.train_fused.launches == before
    extra = len(got) - len(base)
    assert extra == (3 if kw.get("input_grads") else 1)
    for a, b in zip(got[:4] + got[4 + extra:], base):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert fused_train._mode(True, False, kw.get("want_weights", False),
                             kw.get("input_grads", False)) == pair
    assert pair in fused_train.train_fused.points
