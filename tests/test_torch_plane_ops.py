"""The plane-op kernels' plain versions in the port against the JAX
package's Pallas kernels (interpret mode), on the same seeded inputs:

- the standalone composite (``ops/composite.py``) against
  ``pallas_composite.make_composite_op`` under ``jax.vjp``, white and
  black background, with a cotangent on every lane (depth and acc
  included): the row and all five plane cotangents, dz included;
- the four-plane forward (``fused_mlp.planes_fwd_plain``) against
  ``fused_mlp.invoke_fwd``;
- the plane-op backward (``fused_train.plane_bwd_plain``) against
  ``fused_train._invoke_bwd`` in all four flag pairs, every output;
- each factory's ``autograd.Function`` against the JAX ``custom_vjp``
  under ``jax.vjp``, outputs and every operand's cotangent.

Tolerances, each with its reason:

- the composite: the same f32 formulas, but the TPU kernel spells the
  exclusive transmittance as exp of a log-space triangular matmul and the
  suffix sums as a matmul, the port as a cumulative product and a flipped
  cumulative sum: rtol 1e-4 with atol 1e-6 of the largest magnitude
  (measured: 1.3e-6 relative);
- the MLP planes and cotangents: both round to bf16 at the same points
  and differ by f32 summation order, which flips an occasional bf16
  rounding: relative L2 below 5e-3 and every element within 1e-2 of the
  largest plus 5e-3 relative (``test_torch_fused_train._close``), the
  sigma head's cancelling sums scaled by their terms' magnitudes
  (``test_torch_train_step.py``). The cotangents fed to the backward are
  those of a composite's MSE (``_cotangents``), as on the routes; at 16
  samples both the single pass and the plane op read 0.3e-3 to 2e-3
  against JAX (at 8 samples, where few terms share each ray's sums, both
  read up to 2.6e-2). The input chain's ``d_ro8``, ``d_vd8``
  and ``d_z`` carry PE lanes scaled up to 2^5 here and sums over lanes
  and samples that cancel: twice that bar (``chip_smoke._close``'s
  ``slack``, PERF.md Findings).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu.ops.pallas_composite import make_composite_op
from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import composite, fused_mlp, fused_train

R, S = 32, 16
KW = dict(shape_blocks=2, texture_blocks=1, W=256)
INPUT_CHAIN = ("d_ro8", "d_vd8", "d_z")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """W=256 on the CPU beside the other test workers: two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched, raising=True)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _close(got, want, name, terms=None, slack=1.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    if terms is not None:
        np.testing.assert_allclose(got, want, rtol=5e-3,
                                   atol=1e-2 * float(np.max(terms)),
                                   err_msg=name)
        return
    top = float(np.abs(want).max())
    assert top > 0, name
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 5e-3 * slack, (name, rel_l2)
    np.testing.assert_allclose(got, want, rtol=5e-3 * slack,
                               atol=1e-2 * slack * top, err_msg=name)


def _planes(seed, n=R, s=S):
    rng = np.random.default_rng(seed)
    sig = rng.exponential(2.0, (n, s)).astype(np.float32)
    sig[0, :4] = 0.0
    cs = [rng.normal(0.5, 0.6, (n, s)).astype(np.float32) for _ in range(3)]
    z = np.sort(rng.uniform(0.8, 2.2, (n, s)), -1).astype(np.float32)
    g8 = rng.normal(size=(n, 8)).astype(np.float32)
    return sig, cs, z, g8


@pytest.mark.parametrize("white_bg", [True, False], ids=["white", "black"])
def test_composite_op_matches_jax(white_bg):
    sig, cs, z, g8 = _planes(1)
    op = make_composite_op(white_bg=white_bg)
    ins = [jnp.asarray(x) for x in (sig, *cs, z)]
    want, vjp = jax.vjp(op, *ins)
    want_g = vjp(jnp.asarray(g8))
    leaves = [_t(x).requires_grad_(True) for x in (sig, *cs, z)]
    got = composite.composite_op(*leaves, white_bg=white_bg)
    got.backward(_t(g8))
    assert got.shape == (R, 8)
    top = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-6 * top)
    for name, leaf, w in zip(("gsig", "gc0", "gc1", "gc2", "dz"), leaves,
                             want_g):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=name)
    # the CPU wrappers are the plain versions, and launch nothing
    before = dict(composite.launches)
    args = [_t(x) for x in (sig, *cs, z)]
    np.testing.assert_array_equal(
        composite.composite_fwd(*args, white_bg).numpy(),
        composite.composite_fwd_plain(*args, white_bg).numpy())
    for a, b in zip(composite.composite_bwd(*args, _t(g8), white_bg),
                    composite.composite_bwd_plain(*args, _t(g8), white_bg)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert composite.launches == before


def _setup(seed=3, s=S):
    """Seeded W=256 weights in both packages and the per-ray operands
    from the JAX prologue."""
    jcfg = JNetConfig(**KW)
    jparams = init_codenerf(jax.random.PRNGKey(seed), jcfg)
    cfg = NetConfig(**dataclasses.asdict(jcfg))
    model = CodeNeRF(cfg).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.8, 1.8, (R, s)), -1).astype(np.float32)
    sc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    ops = j_fused_mlp.prep_ray_operands(
        jparams, jcfg, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(sc), jnp.asarray(tc))
    jw = j_ft.flatten_params_f32(jparams, jcfg)
    tops = (_t(ops[0]), _t(ops[1]), _t(ops[2]),
            *(_t(x, torch.bfloat16) for x in ops[3:]))
    return dict(jcfg=jcfg, cfg=cfg, model=model, ops=ops, jw=jw, tops=tops,
                tw=fused_train.flatten_params(model, cfg), rng=rng)


def test_planes_fwd_plain_matches_jax():
    k = _setup()
    wb = [x.astype(jnp.bfloat16) if x.ndim == 2 else x for x in k["jw"]]
    want = j_fused_mlp.invoke_fwd(k["jcfg"], S, R, *k["ops"], wb)
    args = (k["cfg"], S, R, *k["tops"], k["tw"])
    got = fused_mlp.planes_fwd_plain(*args)
    for name, g, w in zip(("sigma", "r", "g", "b"), got, want):
        assert g.shape == (R, S) and g.dtype == torch.float32, name
        _close(g.numpy(), w, name)
    # the sigma plane is the sigma-only forward's, bit for bit
    np.testing.assert_array_equal(got[0].numpy(),
                                  fused_mlp.sigma_fwd_plain(*args).numpy())
    before = dict(fused_mlp.planes_fwd.launches)
    for a, b in zip(fused_mlp.planes_fwd(*args), got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert fused_mlp.planes_fwd.launches == before
    with pytest.raises(ValueError, match="shape"):
        fused_mlp.planes_fwd(k["cfg"], S + 1, R, *args[3:])
    # fused_codenerf_apply: the same planes from rays, depths and codes
    jr = k["rng"]
    ro = jr.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = jr.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = np.sort(jr.uniform(0.8, 1.8, (R, S)), -1).astype(np.float32)
    code = (jr.normal(size=(256,)) * 0.1).astype(np.float32)
    jparams = init_codenerf(jax.random.PRNGKey(3), k["jcfg"])
    wsig, wrgb = j_fused_mlp.fused_codenerf_apply(
        jparams, k["jcfg"], jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(code), jnp.asarray(code))
    gsig, grgb = fused_mlp.fused_codenerf_apply(
        k["model"], k["cfg"], _t(ro), _t(vd), _t(z), _t(code), _t(code))
    _close(gsig.numpy(), wsig, "sigma")
    for name, g, w in zip("rgb", grgb, wrgb):
        _close(g.numpy(), w, name)


def _cotangents(k, s=S, white_bg=True):
    """The cotangents the plane op sees on its routes: ``g8``, a per-ray
    row with the MSE of a composite of the op's own planes against a
    random target on lanes 0..2 and a depth term on lane 3, and the four
    plane cotangents that the composite's backward makes of it (f32, fed
    to both packages)."""
    wb = [x.astype(jnp.bfloat16) if x.ndim == 2 else x for x in k["jw"]]
    planes = [_t(p) for p in j_fused_mlp.invoke_fwd(k["jcfg"], s, R,
                                                    *k["ops"], wb)]
    z = _t(k["ops"][2])
    out8 = composite.composite_fwd_plain(*planes, z, white_bg)
    gt = _t(k["rng"].uniform(0.0, 1.0, (R, 8)))
    lane = torch.arange(8)
    g8 = torch.where(lane < 3, 2.0 * (out8 - gt) / (3 * R),
                     torch.where(lane == 3, 0.1 * (out8 - gt) / R, 0.0))
    gp = composite.composite_bwd_plain(*planes, z, g8, white_bg)[:4]
    return g8.numpy(), [g.numpy() for g in gp]


def _names(cfg, weight_grads, input_grads):
    names = list(INPUT_CHAIN) if input_grads else []
    names += ["d_sproj", "d_tproj", "d_vcontrib"]
    if weight_grads:
        names += [f"{n}.{p}" for n, _, _ in fused_train.weight_shapes(cfg)
                  for p in ("w", "b")]
    return names


@pytest.mark.parametrize("weight_grads,input_grads",
                         [(True, False), (False, False), (False, True),
                          (True, True)],
                         ids=["train", "codes", "pose", "train_input"])
def test_plane_bwd_plain_matches_jax(weight_grads, input_grads):
    k = _setup(5)
    _, gp = _cotangents(k)
    want = j_ft._invoke_bwd(k["jcfg"], S, R, *k["ops"], k["jw"],
                            tuple(jnp.asarray(g) for g in gp),
                            weight_grads=weight_grads,
                            input_grads=input_grads)
    terms = []
    got = fused_train.plane_bwd_plain(
        k["cfg"], S, R, *k["tops"], k["tw"], [_t(g) for g in gp],
        weight_grads, input_grads, sigma_terms=terms)
    names = _names(k["cfg"], weight_grads, input_grads)
    assert len(got) == len(want) == len(names)
    scale_of = dict(zip(["sigma.w", "sigma.b"], [x.numpy() for x in terms]))
    for g, w, name in zip(got, want, names):
        assert tuple(g.shape) == tuple(w.shape), name
        assert g.dtype == (torch.bfloat16 if name in (
            "d_sproj", "d_tproj", "d_vcontrib") else torch.float32), name
        _close(g.float().numpy(), w, name, scale_of.get(name),
               slack=2.0 if name in INPUT_CHAIN else 1.0)
    before = dict(fused_train.plane_bwd.launches)
    again = fused_train.plane_bwd(k["cfg"], S, R, *k["tops"], k["tw"],
                                  [_t(g) for g in gp], weight_grads,
                                  input_grads)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert fused_train.plane_bwd.launches == before
    assert fused_train._plane_mode(weight_grads, input_grads) in before


FACTORIES = {
    "train": (lambda c: j_ft.make_fused_train_op(c),
              lambda c: fused_train.make_fused_train_op(c), True, True),
    "train_no_input": (
        lambda c: j_ft.make_fused_train_op(c, input_grads=False),
        lambda c: fused_train.make_fused_train_op(c, input_grads=False),
        True, False),
    "codes": (j_ft.make_fused_codes_op, fused_train.make_fused_codes_op,
              False, False),
    "pose": (j_ft.make_fused_pose_op, fused_train.make_fused_pose_op, False,
             True),
    "train_composite": (
        lambda c: j_ft.make_fused_train_composite_op(c, white_bg=True),
        lambda c: fused_train.make_fused_train_composite_op(c, True), True,
        True),
    "codes_composite": (
        lambda c: j_ft.make_fused_codes_composite_op(c, white_bg=False),
        lambda c: fused_train.make_fused_codes_composite_op(c, False), False,
        False),
}


@pytest.mark.parametrize("factory", list(FACTORIES))
def test_factory_ops_match_jax_custom_vjp(factory):
    """Each factory's op under autograd against the JAX op under
    ``jax.vjp``: its outputs, then the cotangent of every operand — zero
    (None in the port) where the mode computes none."""
    make_j, make_t, weight_grads, input_grads = FACTORIES[factory]
    k = _setup(7)
    jop, top = make_j(k["jcfg"]), make_t(k["cfg"])
    jins = list(k["ops"]) + list(k["jw"])
    want, vjp = jax.vjp(jop, *jins)
    comp = "composite" in factory
    white = factory != "codes_composite"
    g8, gp = _cotangents(k, S, white)
    gout = [g8] if comp else gp
    if comp:
        want = [want]
    want_g = vjp(jnp.asarray(gout[0]) if comp
                 else tuple(jnp.asarray(g) for g in gout))
    leaves = [x.clone().requires_grad_(True)
              for x in list(k["tops"]) + list(k["tw"])]
    got = top(*leaves)
    got = [got] if comp else list(got)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.detach().numpy(), w, f"output {i}")
    torch.autograd.backward(got, [_t(g) for g in gout])
    # The sigma head's sums cancel: their bar scales with their terms'
    # magnitudes, from the plain backward on the planes' cotangents.
    args = (k["cfg"], S, R, *k["tops"], k["tw"])
    gp = [_t(g) for g in gout]
    if comp:
        planes = fused_mlp.planes_fwd_plain(*args)
        gp = composite.composite_bwd_plain(*planes, k["tops"][2], gp[0],
                                           white)[:4]
    terms = []
    fused_train.plane_bwd_plain(*args, gp, True, False, sigma_terms=terms)
    scale_of = dict(zip(["sigma.w", "sigma.b"], [x.numpy() for x in terms]))
    names = (["ro8", "vd8", "z", "sproj", "tproj", "vcontrib"]
             + [f"{n}.{p}" for n, _, _ in fused_train.weight_shapes(k["cfg"])
                for p in ("w", "b")])
    for leaf, w, name in zip(leaves, want_g, names):
        w = np.asarray(w, np.float32)
        grad = (np.zeros(w.shape, np.float32) if leaf.grad is None
                else leaf.grad.float().numpy())
        computed = (name in ("sproj", "tproj", "vcontrib")
                    or (input_grads and name in ("ro8", "vd8", "z"))
                    or (weight_grads and "." in name)
                    or (comp and name == "z"))
        if not computed:
            np.testing.assert_array_equal(grad, 0.0, err_msg=name)
            np.testing.assert_array_equal(w, 0.0, err_msg=name)
        else:
            _close(grad, w, name, scale_of.get(name),
                   slack=2.0 if name in ("ro8", "vd8", "z") else 1.0)


def test_composite_cumprod_backward_is_torchs():
    """``core.render.composite`` takes its transmittance's cumulative
    product through a Function whose backward is PyTorch's own formula
    for an input with no zero, without PyTorch's check for zeros (a read
    from the device in every backward of the plane-op routes): the same
    values and gradients as ``torch.cumprod``, bit for bit."""
    from codenerf_tpu_torch.core.render import _CumprodPositive

    rng = np.random.default_rng(2)
    x = _t(rng.uniform(1e-10, 1.0, (R, S))).requires_grad_(True)
    g = _t(rng.normal(size=(R, S)))
    want = torch.cumprod(x, -1)
    (want_g,) = torch.autograd.grad(want, x, g)
    got = _CumprodPositive.apply(x)
    (got_g,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got, want) and torch.equal(got_g, want_g)
