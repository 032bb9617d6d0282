"""Hierarchical sampling in the port against the JAX package, on the same
seeded inputs: the sampler and the union merge, the sigma-only forward
(plain version) against ``invoke_fwd(sigma_only=True)`` and the dual-
composite mode (plain version) against ``invoke_train_fused(coarse_mask=,
coarse_delta=)``, both in Pallas interpret mode; one hierarchical
training step's gradients on both routes, one code-optimization chunk, and
the eval render with sphere bounds and an occupancy grid.

Tolerances, each with its reason:

- ``union_sorted_zvals`` and ``merge_sorted_samples``: exact — depths
  and permutation, ties included;
- ``sample_pdf``, random (the JAX package's own uniforms) and
  deterministic: every sample in the same cdf interval, and within 2e-6
  (depths ~1.5, an f32 ulp 1.2e-7) where that interval holds at least
  1e-3 of the mass: the pdf's sum and the cdf's cumulative sum associate
  differently (XLA's CPU sums in order, PyTorch's vectorised), a few ulps
  apart, and the probes lie within two ulps (``test_torch_occupancy.py``);
  a sample in an interval of mass m moves by its width times that error
  over m, so an almost empty bin (weight 1e-5) amplifies it. Measured:
  4.8e-7;
- ``hier_fine_zvals`` and ``hier_fine_zvals_meta``, given the same coarse
  weights and uniforms: the depths within that bar, the permutation —
  ``cmask`` and ``cdelta`` — exact;
- ``composite_weights``: rtol 1e-5, atol 1e-7 (the same f32 formulas;
  the cumulative product may associate differently);
- the sigma-only forward: both round to bf16 at the same points and
  differ by f32 summation order, which flips an occasional bf16 rounding
  of an activation: relative L2 below 5e-3 and every sigma within 1e-2
  of the largest plus 5e-3 relative (the bar of
  ``test_torch_fused_train._close``);
- the dual mode: that same bar on every cotangent and dW/db, the sigma
  head's cancelling sums scaled by their terms' magnitudes (as in
  ``test_torch_train_step.py``), both SEs at rtol 1e-4;
- a training step and a code-optimization chunk against the JAX
  package's own step on the same trainables, depths and uniforms, the
  loss and the fine MSE within 1e-3 relative. The gradients: on the
  fused route, where both round at the same points, relative L2 below
  1e-2 per trainable group (the two kernels' summation orders, through a
  prologue that rounds to bf16); on the autodiff route, where XLA and
  PyTorch round the plain bf16 model at different points, at least as
  close to the JAX step in f32 as the JAX step in bf16 is
  (``rel_port <= 1.5·rel_xla_bf16 + 1e-3``, the bar of
  ``test_torch_train_step.test_step_grads_match_jax``);
- the eval render: within 2e-3 per pixel (the plain bf16 model rounds at
  different points in XLA and PyTorch; the fine depths follow the coarse
  weights continuously).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codenerf_tpu import renderer as j_renderer
from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.core import occupancy as j_occ
from codenerf_tpu.core import rays as j_rays
from codenerf_tpu.core import sampling as j_sampling
from codenerf_tpu.core.render import composite_weights as j_composite_weights
from codenerf_tpu.data.synthetic import synthetic_scene
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu.training import state as j_state
from codenerf_tpu.training import train_step as j_train_step
from codenerf_tpu_torch import renderer
from codenerf_tpu_torch.config import NetConfig, hparams_from_dict
from codenerf_tpu_torch.core import occupancy as occ
from codenerf_tpu_torch.core import sampling
from codenerf_tpu_torch.core.render import composite, composite_weights
from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.optimization import codes_opt
from codenerf_tpu_torch.training import train_step
from codenerf_tpu_torch.training.state import trainables_from_jax

torch.set_num_threads(2)     # W=256 on the CPU: keep xdist workers apart


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched, raising=True)


R, SC, SF = 32, 16, 16
KW = dict(shape_blocks=2, texture_blocks=1, W=256)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _close(got, want, name, terms=None):
    """The bar of ``test_torch_train_step._close``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if terms is not None:
        np.testing.assert_allclose(got, want, rtol=5e-3,
                                   atol=1e-2 * float(np.max(terms)),
                                   err_msg=name)
        return
    top = float(np.abs(want).max())
    assert top > 0, name
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 5e-3, (name, rel_l2)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-2 * top,
                               err_msg=name)


def _coarse(seed=0, n=R, s=SC):
    """Sorted coarse depths (duplicated ones included) and nonnegative
    coarse weights (a few all-zero rays included)."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.8, 1.8, (n, s)), axis=-1).astype(np.float32)
    z[0, 5] = z[0, 4]
    w = (rng.exponential(1.0, (n, s)) * (rng.uniform(size=(n, s)) < 0.6)
         ).astype(np.float32)
    w[1] = 0.0
    return z, w


def test_composite_weights_matches_jax():
    rng = np.random.default_rng(1)
    sig = rng.exponential(2.0, (R, SC)).astype(np.float32)
    z, _ = _coarse()
    want = np.asarray(j_composite_weights(jnp.asarray(sig), jnp.asarray(z)))
    got = composite_weights(_t(sig), _t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the weights of composite(), too
    out = composite(_t(sig), _t(np.zeros((R, SC, 3))), _t(z))
    np.testing.assert_array_equal(out.weights.numpy(), got)


@pytest.mark.parametrize("deterministic", [False, True])
def test_sample_pdf_matches_jax(deterministic):
    z, w = _coarse(2)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_sampling.sample_pdf(
        key, jnp.asarray(bins), jnp.asarray(w[:, 1:-1]), SF,
        deterministic=deterministic))
    u = None
    if not deterministic:
        u = _t(jax.random.uniform(key, (R, SF), dtype=jnp.float32,
                                  maxval=1.0 - 1e-6))
    got = sampling.sample_pdf(_t(bins), _t(w[:, 1:-1]), SF,
                              deterministic=deterministic, u=u).numpy()
    want = np.asarray(want)
    idx = (want[:, :, None] >= bins[:, None, 1:-1]).sum(-1)
    np.testing.assert_array_equal(
        (got[:, :, None] >= bins[:, None, 1:-1]).sum(-1), idx)
    wt = w[:, 1:-1] + np.float32(1e-5)
    mass = np.take_along_axis(wt / wt.sum(-1, keepdims=True), idx, 1)
    np.testing.assert_allclose(got[mass > 1e-3], want[mass > 1e-3], rtol=0,
                               atol=2e-6)
    assert (mass > 1e-3).mean() > 0.9
    assert (got >= bins[:, :1]).all() and (got <= bins[:, -1:]).all()


def test_union_and_merge_exact_with_ties():
    """Ties between coarse and fine depths, and among fine ones, resolve
    coarse-first and in input order: the same permutation as JAX's stable
    multi-operand sort, so every payload lands where JAX puts it."""
    z, _ = _coarse(4)
    rng = np.random.default_rng(5)
    zf = np.sort(rng.uniform(0.8, 1.8, (R, SF)), -1).astype(np.float32)
    zf[:, 3] = z[:, 7]
    zf[:, 4] = z[:, 7]
    zf[2, :] = z[2, 0]
    ids_c = np.broadcast_to(np.arange(SC, dtype=np.float32), (R, SC))
    ids_f = np.broadcast_to(SC + np.arange(SF, dtype=np.float32), (R, SF))
    j_all, (j_ids,) = j_sampling.merge_sorted_samples(
        jnp.asarray(z), jnp.asarray(zf), [jnp.asarray(ids_c)],
        [jnp.asarray(ids_f)])
    t_all, (t_ids,) = sampling.merge_sorted_samples(_t(z), _t(zf),
                                                    [_t(ids_c)], [_t(ids_f)])
    np.testing.assert_array_equal(t_all.numpy(), np.asarray(j_all))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(
        sampling.union_sorted_zvals(_t(z), _t(zf)).numpy(),
        np.asarray(j_sampling.union_sorted_zvals(jnp.asarray(z),
                                                 jnp.asarray(zf))))
    np.testing.assert_array_equal(
        sampling.union_sorted_zvals(_t(z[0]), _t(zf)).numpy(),
        np.asarray(j_sampling.union_sorted_zvals(jnp.asarray(z[0]),
                                                 jnp.asarray(zf))))


def test_hier_fine_zvals_and_meta_exact():
    z, w = _coarse(6)
    key = jax.random.PRNGKey(8)
    u = _t(jax.random.uniform(key, (R, SF), dtype=jnp.float32,
                              maxval=1.0 - 1e-6))
    want = j_ft.hier_fine_zvals_meta(jnp.asarray(z), jnp.asarray(w), key, SF)
    got = fused_train.hier_fine_zvals_meta(_t(z), _t(w), None, SF, u=u)
    for g, wnt, name in zip(got, want, ["z_all", "cmask", "cdelta"]):
        assert tuple(g.shape) == (R, SC + SF), name
        if name == "z_all":
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                       atol=2e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt),
                                          err_msg=name)
    assert float(got[1].sum()) == R * SC
    np.testing.assert_allclose(
        fused_train.hier_fine_zvals(_t(z), _t(w), None, SF, u=u).numpy(),
        np.asarray(j_ft.hier_fine_zvals(jnp.asarray(z), jnp.asarray(w), key,
                                        SF)), rtol=0, atol=2e-6)


def _kernel_setup(seed=3):
    """Seeded full-PE W=256 weights in both packages, per-ray operands
    from the JAX prologue, and a real union from seeded coarse depths."""
    jcfg = JNetConfig(**KW)
    jparams = init_codenerf(jax.random.PRNGKey(0), jcfg)
    cfg = NetConfig(**dataclasses.asdict(jcfg))
    model = CodeNeRF(cfg).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z, w = _coarse(seed)
    sc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    z_all, cmask, cdelta = j_ft.hier_fine_zvals_meta(
        jnp.asarray(z), jnp.asarray(w), key, SF)
    ops = j_fused_mlp.prep_ray_operands(
        jparams, jcfg, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(sc), jnp.asarray(tc))
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, model=model, z=z,
                z_all=z_all, cmask=cmask, cdelta=cdelta, ops=ops, gt=gt)


def test_sigma_fwd_plain_matches_jax_sigma_only():
    k = _kernel_setup()
    ro8, vd8, zj, sproj, tproj, vcontrib = k["ops"]
    wb = [x.astype(jnp.bfloat16) if x.ndim == 2 else x
          for x in j_ft.flatten_params_f32(k["jparams"], k["jcfg"])]
    want = j_fused_mlp.invoke_fwd(k["jcfg"], SC, R, ro8, vd8, zj, sproj,
                                  tproj, vcontrib, wb, sigma_only=True)
    args = (k["cfg"], SC, R, _t(ro8), _t(vd8), _t(zj),
            _t(sproj, torch.bfloat16), _t(tproj, torch.bfloat16),
            _t(vcontrib, torch.bfloat16),
            fused_train.flatten_params(k["model"], k["cfg"]))
    got = fused_mlp.sigma_fwd_plain(*args)
    assert got.shape == (R, SC) and got.dtype == torch.float32
    _close(got.numpy(), want, "sigma")
    # the wrapper takes the plain version on CPU tensors, launching nothing
    before = dict(fused_mlp.sigma_fwd.launches)
    np.testing.assert_array_equal(fused_mlp.sigma_fwd(*args).numpy(),
                                  got.numpy())
    assert fused_mlp.sigma_fwd.launches == before
    with pytest.raises(ValueError, match="shape"):
        fused_mlp.sigma_fwd(k["cfg"], SC + 1, R, *args[3:])


@pytest.mark.parametrize("weight_grads", [False, True])
def test_dual_mode_plain_matches_jax_kernel(weight_grads):
    """The dual composite at a real union (16 coarse + 16 fine), both
    modes: the fine and coarse SEs, the cotangents and (training) every
    dW/db. The fine SE also equals the non-dual mode's on the same union,
    and the coarse SE a plain composite of the coarse samples alone."""
    k = _kernel_setup(5)
    jcfg, cfg = k["jcfg"], k["cfg"]
    ro8, vd8, _, sproj, tproj, vcontrib = k["ops"]
    S = SC + SF
    gt8 = j_fused_mlp._pad_lanes(jnp.asarray(k["gt"]), 8)
    scale = 1.0 / (R * 3.0)
    kw = dict(weight_grads=weight_grads, want_rgb=not weight_grads)
    want = j_ft.invoke_train_fused(
        jcfg, S, R, True, scale, ro8, vd8, k["z_all"], sproj, tproj,
        vcontrib, gt8, j_ft.flatten_params_f32(k["jparams"], jcfg),
        coarse_mask=k["cmask"], coarse_delta=k["cdelta"], **kw)
    targs = (cfg, S, R, True, scale, _t(ro8), _t(vd8), _t(k["z_all"]),
             _t(sproj, torch.bfloat16), _t(tproj, torch.bfloat16),
             _t(vcontrib, torch.bfloat16), _t(gt8),
             fused_train.flatten_params(k["model"], cfg))
    terms = []
    got = fused_train.train_fused_plain(
        *targs, sigma_terms=terms, coarse_mask=_t(k["cmask"]),
        coarse_delta=_t(k["cdelta"]), **kw)
    assert len(got) == len(want)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-4)
    names = ["d_sproj", "d_tproj", "d_vcontrib"]
    if weight_grads:
        names += [f"{n}.{p}" for n, _, _ in fused_train.weight_shapes(cfg)
                  for p in ("w", "b")]
    else:
        names += ["rgb8"]
    scale_of = dict(zip(["sigma.w", "sigma.b"], [x.numpy() for x in terms]))
    for g, w, name in zip(got[2:], want[2:], names):
        assert tuple(g.shape) == tuple(w.shape), name
        if name == "rgb8":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                       atol=1e-4, err_msg=name)
        else:
            _close(g.float().numpy(), w, name, scale_of.get(name))

    # Cross-checks on the plain version alone: the fine SE is the
    # non-dual mode's on the same union, the coarse SE a call on the
    # coarse depths alone (the fine samples add alpha 0 and a
    # transmittance factor of 1).
    single = fused_train.train_fused_plain(*targs, weight_grads=False)
    np.testing.assert_allclose(float(got[0]), float(single[0]), rtol=1e-6)
    coarse_only = fused_train.train_fused_plain(
        cfg, SC, *targs[2:7], _t(k["z"]), *targs[8:], weight_grads=False)
    np.testing.assert_allclose(float(got[1]), float(coarse_only[0]),
                               rtol=1e-4)


def _scene():
    return synthetic_scene(n_objects=3, n_views=4, H=16, W=16, seed=0)


def _hparams(scene, fused, **extra):
    cfg = {"net_hyperparams": {**KW, "num_xyz_freq": 6, "num_dir_freq": 2,
                               "latent_dim": 32},
           "N_samples": SC, "N_importance": SF,
           "near": float(scene["near"]), "far": float(scene["far"]),
           "use_fused_train": fused, "bound_sphere_radius": 1.4, **extra}
    return j_hparams_from_dict(cfg), hparams_from_dict(cfg)


def _grad_recorder():
    """An optax transformation whose state becomes the gradients it is
    given (and whose updates are zero): the JAX step's gradients, read
    from its new opt_state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _occ_grid_pair(G=8, seed=0):
    rng = np.random.default_rng(seed)
    occ_np = np.asarray(j_occ.dilate_grid(jnp.asarray(
        rng.uniform(size=(G, G, G)) < 0.05)))
    return (j_occ.OccupancyGrid(occ=jnp.asarray(occ_np),
                                radius=jnp.asarray(1.4, jnp.float32)),
            occ.OccupancyGrid(torch.from_numpy(occ_np.copy()), 1.4))


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _port_grads(state):
    params = {}
    for name, lin in state.model.named_children():
        params[name] = {"b": lin.bias.grad.numpy(),
                        "w": lin.weight.grad.numpy().T}
    return {"params": params, "shape_codes": state.shape_codes.grad.numpy(),
            "texture_codes": state.texture_codes.grad.numpy()}


@pytest.mark.parametrize("route", ["fused", "autodiff"])
def test_hier_step_grads_match_jax(route):
    """One hierarchical step with sphere bounds and an occupancy grid:
    the JAX package's own step (its gradients read back through
    ``_grad_recorder``) against the port's ``grad_fn`` fed the depths and
    uniforms the JAX step drew."""
    scene = _scene()
    jhp, hp = _hparams(scene, route == "fused",
                       train_occupancy={"grid_size": 8})
    jgrid, tgrid = _occ_grid_pair()
    H, W = scene["images"].shape[2:4]
    tx = _grad_recorder()
    jst = j_state.create_train_state(jax.random.PRNGKey(0), jhp, 3, tx)
    batch = RayBatchPipeline(scene["images"], scene["poses"],
                             scene["focals"], seed=2).sample(R)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_step(hparams):
        step = j_train_step.build_train_step(hparams, H, W, tx,
                                             batch_size=R)
        return step(jst, jbatch, jgrid)

    new_state, jm = jax_step(jhp)
    # The step's draws: key = split(rng)[1], then coarse_zvals's split.
    key = jax.random.split(jst.rng)[1]
    ro, vd = j_rays.pixel_rays(jnp.asarray(batch["uv"]),
                                   jnp.asarray(batch["focal"]),
                                   jnp.asarray(batch["c2w"]), H, W)
    z, key_fine = j_renderer.coarse_zvals(jhp.render, ro, vd, key,
                                          occ_grid=jgrid)
    u = jax.random.uniform(key_fine, (R, SF), dtype=jnp.float32,
                           maxval=1.0 - 1e-6)
    jtr = jax.tree_util.tree_map(np.asarray, jst.trainables)
    state = trainables_from_jax(jtr, hp, device="cpu")
    grad_fn = train_step.build_grad_fn(hp, H, W, batch_size=R)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    m = grad_fn(state, tb, z=_t(z), u=_t(u), occ_grid=tgrid)
    for name in ("loss", "mse", "reg"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-3, err_msg=name)
    assert float(m["loss"]) > 1.9 * float(m["mse"])   # fine + coarse
    want, got = new_state.opt_state, _port_grads(state)
    if route == "autodiff":
        ref = jax_step(dataclasses.replace(jhp, compute_dtype="float32"))[0]
    for key_ in ("params", "shape_codes", "texture_codes"):
        w_, g_ = _flat(want[key_]), _flat(got[key_])
        if route == "fused":
            rel = np.linalg.norm(g_ - w_) / np.linalg.norm(w_)
            assert rel < 1e-2, (key_, rel)
            continue
        r_ = _flat(ref.opt_state[key_])
        rel_xla = np.linalg.norm(w_ - r_) / np.linalg.norm(r_)
        rel_port = np.linalg.norm(g_ - r_) / np.linalg.norm(r_)
        assert rel_port <= 1.5 * rel_xla + 1e-3, (key_, rel_port, rel_xla)


def test_hier_codes_opt_chunk_matches_jax():
    """One code-optimization chunk on the hierarchical single-pass route
    (sigma-only coarse pass, dual frozen kernel): the optimized loss, the
    reported (fine) MSE and the codes' gradients against the same chain
    of JAX package functions (``codes_opt.py:345-381``) on the same
    depths and uniforms."""
    scene = _scene()
    jhp, hp = _hparams(scene, True)
    jcfg, rcfg = jhp.net, jhp.render
    jparams = init_codenerf(jax.random.PRNGKey(0), jcfg)
    model = CodeNeRF(hp.net).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    rng = np.random.default_rng(9)
    sc = (rng.normal(size=(32,)) * 0.3).astype(np.float32)
    tc = (rng.normal(size=(32,)) * 0.3).astype(np.float32)
    ro, vd = j_rays.camera_rays(16, 16, float(scene["focals"][0]),
                                    jnp.asarray(scene["poses"][0, 0]))
    ro, vd = ro[:R * 2:2], vd[:R * 2:2]
    gt = jnp.asarray(rng.uniform(0, 1, (R, 3)).astype(np.float32))
    key = jax.random.PRNGKey(4)
    z2d, key_fine = j_renderer.coarse_zvals(rcfg, ro, vd, key)
    u = jax.random.uniform(key_fine, (R, SF), dtype=jnp.float32,
                           maxval=1.0 - 1e-6)
    scale = 1.0 / (R * 3.0)
    wflat = j_ft.flatten_params_f32(jparams, jcfg)
    f32 = jnp.float32

    def jax_chunk(codes):
        s, t = codes
        ro8 = j_fused_mlp._pad_lanes(ro.astype(f32), 8)
        vd8 = j_fused_mlp._pad_lanes(vd.astype(f32), 8)
        gt8 = j_fused_mlp._pad_lanes(gt, 8)

        def prologue(cds):
            return j_fused_mlp.prep_ray_operands(jparams, jcfg, ro, vd, z2d,
                                                 *cds)[3:]

        (sproj, tproj, vcontrib), pvjp = jax.vjp(prologue, codes)
        wb = [w.astype(jnp.bfloat16) if w.ndim == 2 else w for w in wflat]
        sigma_c = j_fused_mlp.invoke_fwd(jcfg, SC, R, ro8, vd8, z2d, sproj,
                                         tproj, vcontrib, wb,
                                         sigma_only=True)
        z_all, cmask, cdelta = j_ft.hier_fine_zvals_meta(
            z2d, j_composite_weights(sigma_c, z2d), key_fine, SF)
        outs = j_ft.invoke_train_fused(
            jcfg, SC + SF, R, rcfg.white_bg, scale, ro8, vd8, z_all, sproj,
            tproj, vcontrib, gt8, wflat, weight_grads=False,
            coarse_mask=cmask, coarse_delta=cdelta)
        (g,) = pvjp(tuple(outs[2:5]))
        return outs[0] * scale, (outs[0] + outs[1]) * scale, g

    fine_w, loss_w, g_w = jax_chunk((jnp.asarray(sc), jnp.asarray(tc)))
    st = torch.tensor(sc, requires_grad=True)
    tt = torch.tensor(tc, requires_grad=True)
    trunk = fused_train.trunk_operands(model, hp.net)
    loss, fine, rgb8 = codes_opt._chunk_loss(
        model, hp, trunk, _t(ro), _t(vd), _t(gt), st, tt, scale, None, False,
        z=_t(z2d), u=_t(u))
    loss.backward()
    assert rgb8.numel() == 0
    np.testing.assert_allclose(float(loss.detach()), float(loss_w), rtol=1e-3)
    np.testing.assert_allclose(float(fine), float(fine_w), rtol=1e-3)
    assert float(loss.detach()) > 1.5 * float(fine)
    for got, want, name in zip([st.grad, tt.grad], g_w, ["shape", "texture"]):
        rel = np.linalg.norm(got.numpy() - np.asarray(want)) / \
            np.linalg.norm(np.asarray(want))
        assert rel < 1e-2, (name, rel)


def test_render_image_hier_matches_jax():
    """Deterministic eval render: sphere bounds, an occupancy grid, the
    coarse pass and the fine pass merged with the cached coarse planes."""
    scene = _scene()
    jhp, hp = _hparams(scene, False, occ_probes=16)
    jcfg = jhp.net
    jparams = init_codenerf(jax.random.PRNGKey(0), jcfg)
    model = CodeNeRF(hp.net).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    codes = np.asarray(init_codes(jax.random.PRNGKey(1), 2, 32))
    jgrid, tgrid = _occ_grid_pair(seed=3)
    focal, c2w = float(scene["focals"][1]), scene["poses"][1, 2]
    want = np.asarray(j_renderer.render_image(
        jparams, jcfg, jhp.render, 16, 16, focal, jnp.asarray(c2w),
        jnp.asarray(codes[0]), jnp.asarray(codes[1]), key=None, chunk=128,
        occ_grid=jgrid))
    got = renderer.render_image(model, hp.render, 16, 16, focal, c2w,
                                _t(codes[0]), _t(codes[1]), None, chunk=128,
                                occ_grid=tgrid).numpy()
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    plain = renderer.render_image(model, hp.render, 16, 16, focal, c2w,
                                  _t(codes[0]), _t(codes[1]), None,
                                  chunk=128).numpy()
    assert np.abs(plain - got).max() > 1e-3     # the grid is not vacuous
