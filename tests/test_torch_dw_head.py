"""The plain versions of the weight-gradient kernel and of the head kernel
(on the CPU) against the JAX package's ``invoke_train_fused`` in Pallas
interpret mode, on the same seeded inputs (W=256, 2 shape blocks, R=32,
S=24):

- ``weight_grads_plain`` on each layer's (input, output cotangent) pair as
  the JAX kernel itself formed it (recorded from its ``dot_acc``) against
  the JAX kernel's dW/db of that layer (``weight_grads=True``), one case
  per layer; and the port's plain chain calling it for every layer;
- ``head_plain`` (softplus, the composite, the loss and its backward) on
  the port's plain forward against the JAX kernel's squared errors and
  composited rows (``want_rgb``), in the single and the dual mode.

Tolerances, each with its reason. dW/db: both sides sum the same exact
products of bf16 values (each exact in f32) over the same 768 points in
f32, in another order; recursive summation of n terms errs by at most
(n - 1)·2^-24 times the sum of the terms' magnitudes, so the two differ
elementwise by at most 2·768·2^-24·Σ|x|·|gh| (the plain chain's pairs
differ from the JAX kernel's by flipped bf16 roundings, which
``tests/test_torch_train_step.py`` bounds end to end). The SEs at rtol
1e-4 (an f32 sum over the rays); the composited rows at 1e-4 absolute,
since one flipped bf16 activation moves a ray's color by ~2e-5
(``tests/test_torch_fused_train.py``).
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
from codenerf_tpu_torch.ops import fused_mlp, fused_train

torch.set_num_threads(2)     # W=256 on the CPU: keep xdist workers apart


@pytest.fixture(scope="module", autouse=True)
def _interpret_pallas():
    """Pallas in interpret mode for the whole module (its module-scoped
    fixtures run the JAX kernel once for every case)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", patched, raising=True)
    yield
    mp.undo()


R, S = 32, 24
SC = 12                      # the dual mode: 12 coarse + 12 fine depths
KW = dict(shape_blocks=2, texture_blocks=1, W=256)
SCALE = 1.0 / (R * 3.0)
# The layers whose dW/db weight_grads_plain forms (every weight but the
# sigma row, whose gradient is the head's Σ t·dsig).
LAYERS = ["enc_xyz", "shape_0", "shape_1", "enc_shape", "enc_viewdir_pt",
          "texture_0", "rgb_hidden", "rgb_out"]


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


@pytest.fixture(scope="module")
def setup():
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
    zc = np.sort(rng.uniform(0.3, 2.2, (R, SC)).astype(np.float32), axis=-1)
    wc = rng.exponential(1.0, (R, SC)).astype(np.float32)
    z_all, cmask, cdelta = j_ft.hier_fine_zvals_meta(
        jnp.asarray(zc), jnp.asarray(wc), jax.random.PRNGKey(2), S - SC)
    ops = j_fused_mlp.prep_ray_operands(
        jparams, jcfg, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(sc), jnp.asarray(tc))
    gt8 = j_fused_mlp._pad_lanes(jnp.asarray(gt), 8)
    ro8, vd8, zj, sproj, tproj, vcontrib = ops
    wflat = fused_train.flatten_params(model.requires_grad_(False), cfg)
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, ops=ops, gt8=gt8,
                z_all=z_all, cmask=cmask, cdelta=cdelta, wflat=wflat,
                ro8=_t(ro8), vd8=_t(vd8), z=_t(zj),
                sproj=_t(sproj, torch.bfloat16),
                tproj=_t(tproj, torch.bfloat16),
                vcontrib=_t(vcontrib, torch.bfloat16))


def _acts(k, z):
    wops = fused_train.kernel_operands(k["wflat"])
    return wops, fused_mlp.forward_plain(
        k["cfg"], R, S, k["ro8"], k["vd8"], z, k["sproj"], k["tproj"],
        k["vcontrib"], wops)


# The order in which one tile of the JAX kernel accumulates its dW/db
# (_tile_backward, from the head down).
ACC_ORDER = ["rgb_out", "rgb_hidden", "texture_0", "enc_viewdir_pt",
             "enc_shape", "shape_1", "shape_0", "enc_xyz"]


@pytest.fixture(scope="module")
def grads(setup):
    """The JAX kernel's dW/db by name and the (x, gh) pairs it formed them
    from (every tile's, recorded at its ``dot_acc`` calls), and the
    port's (x, gh) pairs by name from its plain chain (forward, head, dx
    chain) on the same inputs."""
    k = setup
    cfg, jcfg = k["cfg"], k["jcfg"]
    seen = []
    helpers = j_ft._tile_helpers

    def recording_helpers(*args, **kwargs):
        h = helpers(*args, **kwargs)
        dot_acc = h.dot_acc

        def recorded(x, g, _i=[0]):
            i = _i[0] % len(ACC_ORDER)     # the layer, from the trace order
            _i[0] += 1
            jax.debug.callback(
                lambda x, g: seen.append((ACC_ORDER[i], np.asarray(x),
                                          np.asarray(g))), x, g)
            return dot_acc(x, g)

        h.dot_acc = recorded
        return h

    mp = pytest.MonkeyPatch()
    mp.setattr(j_ft, "_tile_helpers", recording_helpers)
    try:
        want = j_ft.invoke_train_fused(
            jcfg, S, R, True, SCALE, *k["ops"], k["gt8"],
            j_ft.flatten_params_f32(k["jparams"], jcfg), weight_grads=True)
        jax.block_until_ready(want)
    finally:
        mp.undo()
    names = [n for n, _, _ in fused_train.weight_shapes(cfg)]
    jdw = {n: (want[4 + 2 * i], want[5 + 2 * i]) for i, n in enumerate(names)}
    jpairs = {}
    for name, x, g in seen:
        xs, gs = jpairs.get(name, ([], []))
        jpairs[name] = (xs + [x], gs + [g])
    assert sorted(jpairs) == sorted(LAYERS)
    jpairs = {n: tuple(_t(np.concatenate(v), torch.bfloat16) for v in xg)
              for n, xg in jpairs.items()}
    wops, acts = _acts(k, k["z"])
    _, _, _, g_sigma, g_rgb, _ = fused_train.head_plain(
        R, S, acts["sig_pre"], acts["rgb"], k["z"], _t(k["gt8"]), True,
        SCALE)
    pairs = []
    fused_train.backward_chain_plain(cfg, R, S, acts, k["sproj"], k["tproj"],
                                     wops, g_sigma, g_rgb, True, False,
                                     pairs=pairs)
    return jdw, jpairs, {name: (x, gh) for name, x, gh in pairs}


@pytest.mark.parametrize("layer", LAYERS)
def test_weight_grads_plain_matches_jax_kernel(grads, layer):
    """dW = x^T @ gh and db = Σ gh of one layer, on the pairs the JAX
    kernel formed, against the JAX kernel's accumulators, within the bound
    of f32 summation order over the R·S points."""
    jdw, jpairs, _ = grads
    x, gh = jpairs[layer]
    assert x.shape[0] == gh.shape[0] == R * S
    ((dw, db),) = fused_train.weight_grads_plain([(x, gh)])
    want_w, want_b = jdw[layer]
    assert tuple(dw.shape) == tuple(want_w.shape), layer
    assert tuple(db.shape) == tuple(want_b.shape), layer
    assert dw.dtype == db.dtype == torch.float32
    ((terms_w, terms_b),) = fused_train.weight_grads_plain(
        [(x.float().abs(), gh.float().abs())])
    bar = 2.0 * R * S * 2.0 ** -24
    for got, want, terms, name in ((dw, want_w, terms_w, "w"),
                                   (db, want_b, terms_b, "b")):
        err = np.abs(got.numpy() - np.asarray(want, np.float32))
        assert float(np.abs(np.asarray(want)).max()) > 0, (layer, name)
        assert (err <= bar * terms.numpy()).all(), (
            layer, name, float((err / np.maximum(terms.numpy(), 1e-30)).max()))


def test_weight_grads_plain_is_the_chains(setup, grads):
    """train_fused_plain's dW/db of every layer are weight_grads_plain's on
    the chain's pairs, bit for bit, in weight_shapes order."""
    k = setup
    _, _, pairs = grads
    got = fused_train.train_fused_plain(
        k["cfg"], S, R, True, SCALE, k["ro8"], k["vd8"], k["z"], k["sproj"],
        k["tproj"], k["vcontrib"], _t(k["gt8"]), k["wflat"],
        weight_grads=True)
    names = [n for n, _, _ in fused_train.weight_shapes(k["cfg"])]
    for name in LAYERS:
        i = names.index(name)
        ((dw, db),) = fused_train.weight_grads_plain([pairs[name]])
        assert torch.equal(got[4 + 2 * i], dw), name
        assert torch.equal(got[5 + 2 * i], db), name


@pytest.mark.parametrize("dual", [False, True])
def test_head_plain_matches_jax_kernel(setup, dual):
    """The head's squared error(s) and composited rows against the JAX
    kernel's frozen mode with ``want_rgb`` (the dual mode at a real union
    of 12 coarse and 12 fine depths); the weights plane (single mode) is
    the composite's own, and every output is finite."""
    k = setup
    jcfg = k["jcfg"]
    ro8, vd8, zj, sproj, tproj, vcontrib = k["ops"]
    kw = {}
    z = k["z"]
    if dual:
        zj = k["z_all"]
        z = _t(zj)
        kw = dict(coarse_mask=k["cmask"], coarse_delta=k["cdelta"])
    want = j_ft.invoke_train_fused(
        jcfg, S, R, True, SCALE, ro8, vd8, zj, sproj, tproj, vcontrib,
        k["gt8"], j_ft.flatten_params_f32(k["jparams"], jcfg),
        weight_grads=False, want_rgb=True, **kw)
    _, acts = _acts(k, z)
    ses, out8, weights, g_sigma, g_rgb, dz = fused_train.head_plain(
        R, S, acts["sig_pre"], acts["rgb"], z, _t(k["gt8"]), True, SCALE,
        *((_t(k["cmask"]), _t(k["cdelta"])) if dual else ()))
    assert len(ses) == (2 if dual else 1)
    for i, se in enumerate(ses):
        np.testing.assert_allclose(float(se), float(want[i]), rtol=1e-4)
    rgb8 = want[len(ses) + 3]
    assert tuple(out8.shape) == tuple(rgb8.shape) == (R, 8)
    np.testing.assert_allclose(out8.numpy(), np.asarray(rgb8), rtol=0,
                               atol=1e-4)
    for x in (g_sigma, *g_rgb):
        assert x.shape == (R, S) and bool(torch.isfinite(x).all())
    if dual:
        assert weights is None and dz is None
    else:
        np.testing.assert_allclose(weights.sum(-1).numpy(),
                                   out8[:, 4].numpy(), rtol=1e-5, atol=1e-6)
        assert dz.shape == (R, S) and bool(torch.isfinite(dz).all())


def test_weight_grads_refuses_cpu_tensors(grads):
    """The CUDA wrapper launches only on CUDA tensors; on the CPU it raises
    (weight_grads_plain is the plain version) and counts nothing."""
    _, _, pairs = grads
    before = fused_train.weight_grads.launches
    with pytest.raises(ValueError, match="weight_grads_plain"):
        fused_train.weight_grads([pairs["shape_0"]])
    assert fused_train.weight_grads.launches == before
