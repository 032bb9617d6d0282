"""The plane-op routes of the port against the JAX package, on the CPU:

- one training step's gradients (the JAX step's, read back through an
  optax transformation that records them) with a separate fine network —
  both networks' weights and both code tables — and with
  ``fused_composite: false`` on the coarse config;
- one code-optimization step's loss and code gradients over a padded view
  (13×13 rays in 3 chunks of 64, 23 pad rays masked out) through the plane
  op chained into the standalone composite, against the same chunks
  through the JAX package's ``render_rays`` and ``build_fused_codes_fns``
  as its ``codes_opt`` loss forms them; the padded result against the
  unpadded one; and the plain autodiff route (``use_fused_train`` off, as
  ``srncar.json``);
- one pose step on the plane-op route with a separate fine network,
  against the JAX ``pose_opt`` loss on the same pixel indices, jitter and
  importance probes;
- the route each package takes for a grid of configs, ray counts and
  ``use_fused`` values, and the tiling rules and chunk plans beneath it.

Tolerances, each with its reason: losses and MSEs within 1e-3 relative;
gradients, where both packages run the plane op (rounding to bf16 at the
same points, differing by f32 summation order, through a prologue that
rounds to bf16), within 1e-2 relative L2 per trainable group (the bar of
``tests/test_torch_hier.py``); on the autodiff route, where XLA and
PyTorch round the plain bf16 model at different points, at least as
close to the JAX step in f32 as the JAX step in bf16 is
(``rel_port <= 1.5·rel_xla_bf16 + 1e-3``). Padded against unpadded: the
same sums over the same rays, 1e-6 relative (f32 summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codenerf_tpu import renderer as j_renderer
from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.core import poses as j_poses
from codenerf_tpu.core import rays as j_rays
from codenerf_tpu.core import sampling as j_sampling
from codenerf_tpu.data.synthetic import synthetic_scene
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu.optimization import codes_opt as j_codes_opt
from codenerf_tpu.training import state as j_state
from codenerf_tpu.training import train_step as j_train_step
from codenerf_tpu_torch import renderer
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.optimization import codes_opt, pose_opt
from codenerf_tpu_torch.training import train_step
from codenerf_tpu_torch.training.state import trainables_from_jax

R, SC, SF, LATENT = 32, 16, 16, 32
NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 256, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": LATENT}


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


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(want).max() > 0 and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_objects=3, n_views=4, H=16, W=16, seed=0)


def _cfg(scene, fused=True, **extra):
    return {"net_hyperparams": NET, "N_samples": SC,
            "near": float(scene["near"]), "far": float(scene["far"]),
            "use_fused_train": fused, **extra}


SEPARATE_FINE = {"N_importance": SF, "hierarchical_share_weights": False,
                 "bound_sphere_radius": 1.4}


def _grad_recorder():
    """An optax transformation whose state becomes the gradients it is
    given (and whose updates are zero)."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _net_grads(model):
    return {name: {"b": lin.bias.grad.numpy(), "w": lin.weight.grad.numpy().T}
            for name, lin in model.named_children()}


@pytest.mark.parametrize("extra", [SEPARATE_FINE, {"fused_composite": False}],
                         ids=["separate_fine", "fused_composite_false"])
def test_plane_op_train_step_grads_match_jax(scene, extra):
    """One plane-op training step: the JAX package's own step against the
    port's ``grad_fn`` fed the depths and uniforms the JAX step drew."""
    jhp = j_hparams_from_dict(_cfg(scene, **extra))
    hp = hparams_from_dict(_cfg(scene, **extra))
    assert not train_step.uses_single_pass_loss(hp)
    H, W = scene["images"].shape[2:4]
    tx = _grad_recorder()
    jst = j_state.create_train_state(jax.random.PRNGKey(0), jhp, 3, tx)
    hier = "N_importance" in extra
    assert ("fine_params" in jst.trainables) == hier
    batch = RayBatchPipeline(scene["images"], scene["poses"],
                             scene["focals"], seed=2).sample(R)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = j_train_step.build_train_step(jhp, H, W, tx, batch_size=R)
    new_state, jm = step(jst, jbatch)
    key = jax.random.split(jst.rng)[1]
    ro, vd = j_rays.pixel_rays(jnp.asarray(batch["uv"]),
                               jnp.asarray(batch["focal"]),
                               jnp.asarray(batch["c2w"]), H, W)
    z, key_fine = j_renderer.coarse_zvals(jhp.render, ro, vd, key)
    u = (_t(jax.random.uniform(key_fine, (R, SF), dtype=jnp.float32,
                               maxval=1.0 - 1e-6)) if hier else None)
    state = trainables_from_jax(
        jax.tree_util.tree_map(np.asarray, jst.trainables), hp)
    assert (state.fine_model is not None) == hier
    grad_fn = train_step.build_grad_fn(hp, H, W, batch_size=R)
    m = grad_fn(state, {k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.items()}, z=_t(z), u=u)
    for name in ("loss", "mse", "reg"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-3, err_msg=name)
    if hier:
        assert float(m["loss"]) > 1.5 * float(m["mse"])    # fine + coarse
    want = new_state.opt_state
    got = {"params": _net_grads(state.model),
           "shape_codes": state.shape_codes.grad.numpy(),
           "texture_codes": state.texture_codes.grad.numpy()}
    if hier:
        got["fine_params"] = _net_grads(state.fine_model)
    assert set(got) == set(want)
    for key_ in got:
        rel = _rel(_flat(got[key_]), _flat(want[key_]))
        assert rel < 1e-2, (key_, rel)


def _codes_setup(scene, fused, **extra):
    jhp = j_hparams_from_dict(_cfg(scene, fused, **extra))
    hp = hparams_from_dict(_cfg(scene, fused, **extra))
    jparams = init_codenerf(jax.random.PRNGKey(2), jhp.net)
    model = CodeNeRF(hp.net).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    img = synthetic_scene(n_objects=1, n_views=1, H=13, W=13, seed=3)
    ro, vd = j_rays.camera_rays(13, 13, float(img["focals"][0]),
                                jnp.asarray(img["poses"][0, 0]))
    gt = jnp.asarray(img["images"][0, 0].reshape(-1, 3).astype(np.float32)
                     / 255.0)
    rng = np.random.default_rng(4)
    codes = [(rng.normal(size=LATENT) * 0.3).astype(np.float32)
             for _ in range(2)]
    return jhp, hp, jparams, model, (ro, vd, gt), codes


def _jax_codes_loss(jhp, jparams, rays, chunk, use_fused=None):
    """The JAX package's code-optimization loss over a padded view, as
    ``codes_opt._build_run.loss_fn`` forms it (deterministic depths):
    the routes of ``build_fused_codes_fns``, the pad mask, ``scale = 1 /
    (3 · real rays)``, the code-norm reg."""
    ro, vd, gt = rays
    n = ro.shape[0]
    chunk, n_chunks, n_padded = j_renderer.chunk_plan(n, chunk)
    apply_fn, composite_fn = j_codes_opt.build_fused_codes_fns(
        jhp, chunk, use_fused=use_fused)
    pad = lambda x: j_renderer.pad_rays(x, n_padded).reshape(
        n_chunks, chunk, -1)
    ro_c, vd_c, gt_c = pad(ro), pad(vd), pad(gt)
    mask = (jnp.arange(n_padded) < n).astype(jnp.float32).reshape(n_chunks,
                                                                 chunk)

    def loss_fn(codes):
        fin = opt = 0.0
        for c in range(n_chunks):
            res = j_renderer.render_rays(
                jparams, jhp.net, jhp.render, ro_c[c], vd_c[c], *codes, None,
                apply_fn=apply_fn, composite_fn=composite_fn,
                compute_dtype=jnp.dtype(jhp.compute_dtype))
            se = jnp.sum(mask[c][:, None] * (res.final.rgb - gt_c[c]) ** 2)
            fin, opt = fin + se, opt + se
        scale = 1.0 / (n * 3.0)
        reg = (j_codes_opt.safe_code_norm(codes[0])
               + j_codes_opt.safe_code_norm(codes[1]))
        return opt * scale + jhp.loss_reg_coef * reg, fin * scale

    return loss_fn, apply_fn, composite_fn


def _port_codes_loss(hp, model, rays, codes, chunk, route):
    """The port's step loss and code gradients, chunk by chunk as
    ``optimize_codes`` runs them (deterministic depths)."""
    ro, vd, gt = (_t(x) for x in rays)
    n = ro.shape[0]
    chunk, n_chunks, n_padded = renderer.chunk_plan(n, chunk)
    assert codes_opt.codes_route(hp, n, chunk) == route
    apply_fn, composite_fn = codes_opt.build_fused_codes_fns(hp, chunk)
    ro, vd, gt = (renderer.pad_rays(x, n_padded) for x in (ro, vd, gt))
    mask = torch.arange(n_padded) < n
    sc, tc = (torch.from_numpy(c).requires_grad_(True) for c in codes)
    loss = fine = 0.0
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        lc, fc, _ = codes_opt._render_chunk_loss(
            model, hp, ro[sl], vd[sl], gt[sl], mask[sl], sc, tc,
            1.0 / (n * 3.0), None, apply_fn=apply_fn,
            composite_fn=composite_fn)
        loss, fine = loss + lc, fine + fc
    loss = loss + hp.loss_reg_coef * (codes_opt.safe_code_norm(sc)
                                      + codes_opt.safe_code_norm(tc))
    loss.backward()
    return float(loss.detach()), float(fine), [sc.grad.numpy(),
                                               tc.grad.numpy()]


def test_padded_codes_step_matches_jax(scene):
    """A 13×13 view in chunks of 64 (3 × 64, 23 pad rays) on the coarse
    fused config: the plane op chained into the standalone composite in
    both packages; then the same step on the unpadded rays."""
    jhp, hp, jparams, model, rays, codes = _codes_setup(scene, True)
    assert renderer.chunk_plan(169, 64) == (64, 3, 192)
    loss_fn, apply_fn, composite_fn = _jax_codes_loss(jhp, jparams, rays, 64)
    assert apply_fn is None and composite_fn is not None
    (loss_w, fine_w), g_w = jax.value_and_grad(loss_fn, has_aux=True)(
        tuple(jnp.asarray(c) for c in codes))
    loss, fine, g = _port_codes_loss(hp, model, rays, codes, 64,
                                     "plane_op_composite")
    np.testing.assert_allclose(loss, float(loss_w), rtol=1e-3)
    np.testing.assert_allclose(fine, float(fine_w), rtol=1e-3)
    for got, want, name in zip(g, g_w, ("shape", "texture")):
        assert _rel(got, want) < 1e-2, name
    # The pad rays add nothing: the unpadded view in one chunk through
    # the same op gives the same loss and gradients.
    ro, vd, gt = (_t(x) for x in rays)
    sc, tc = (torch.from_numpy(c).requires_grad_(True) for c in codes)
    _, composite_t = codes_opt.build_fused_codes_fns(hp, 64)
    lc, fc, _ = codes_opt._render_chunk_loss(
        model, hp, ro, vd, gt, torch.ones(169, dtype=torch.bool), sc, tc,
        1.0 / (169 * 3.0), None, composite_fn=composite_t)
    lc = lc + hp.loss_reg_coef * (codes_opt.safe_code_norm(sc)
                                  + codes_opt.safe_code_norm(tc))
    lc.backward()
    np.testing.assert_allclose(float(lc.detach()), loss, rtol=1e-6)
    np.testing.assert_allclose(float(fc), fine, rtol=1e-6)
    for a, b in zip((sc.grad.numpy(), tc.grad.numpy()), g):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))


def test_autodiff_codes_step_matches_jax(scene):
    """``use_fused_train`` off (as ``srncar.json``): the plain module in
    both packages, on the padded view."""
    jhp, hp, jparams, model, rays, codes = _codes_setup(scene, False)
    jcodes = tuple(jnp.asarray(c) for c in codes)
    (loss_w, fine_w), g_w = jax.value_and_grad(
        _jax_codes_loss(jhp, jparams, rays, 64)[0], has_aux=True)(jcodes)
    jhp32 = dataclasses.replace(jhp, compute_dtype="float32")
    _, g_ref = jax.value_and_grad(
        _jax_codes_loss(jhp32, jparams, rays, 64)[0], has_aux=True)(jcodes)
    loss, fine, g = _port_codes_loss(hp, model, rays, codes, 64, "autodiff")
    np.testing.assert_allclose(loss, float(loss_w), rtol=1e-3)
    np.testing.assert_allclose(fine, float(fine_w), rtol=1e-3)
    for got, want, ref, name in zip(g, g_w, g_ref, ("shape", "texture")):
        rel_xla, rel_port = _rel(want, ref), _rel(got, ref)
        assert rel_port <= 1.5 * rel_xla + 1e-3, (name, rel_port, rel_xla)


def test_plane_op_pose_step_matches_jax(scene):
    """One pose step with a separate fine network on the plane-op route
    (the pose variant of the plane op, the composite's depth cotangent
    through autograd), against the JAX ``pose_opt`` loss
    (``pose_opt.py:114-134``) through ``build_fused_codes_fns(input_grads=
    True)`` on the same pixels, jitter and probes."""
    cfg = _cfg(scene, **SEPARATE_FINE)
    jhp, hp = j_hparams_from_dict(cfg), hparams_from_dict(cfg)
    assert pose_opt.pose_route(hp, R) == "plane_op"
    jparams = init_codenerf(jax.random.PRNGKey(5), jhp.net)
    jfine = init_codenerf(jax.random.PRNGKey(6), jhp.net)
    model, fine = (CodeNeRF(hp.net).requires_grad_(False) for _ in range(2))
    for m, p in ((model, jparams), (fine, jfine)):
        m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                 p)))
    H, W = scene["images"].shape[2:4]
    image = scene["images"][0, 1].astype(np.float32) / 255.0
    c2w = scene["poses"][0, 1].astype(np.float32)
    focal = float(scene["focals"][0])
    # Rays that cross the bounding sphere well: JAX's bounds have a NaN
    # gradient for a ray that misses it (tests/test_torch_pose_opt.py).
    ro, vd = j_rays.camera_rays(H, W, focal, jnp.asarray(c2w))
    b = jnp.sum(ro * vd, -1)
    disc = np.asarray(b * b - (jnp.sum(ro * ro, -1) - 1.4 ** 2))
    pix = np.random.default_rng(5).choice(np.flatnonzero(disc > 0.2), R)
    render_key = jax.random.PRNGKey(5)
    key_z, key_fine = jax.random.split(render_key)
    jitter = j_sampling._uniform01_u8(key_z, R, SC)
    u = jax.random.uniform(key_fine, (R, SF), dtype=jnp.float32,
                           maxval=1.0 - 1e-6)
    rng = np.random.default_rng(2)
    v = {"xi": (rng.normal(size=6) * 0.02).astype(np.float32),
         "shape": (rng.normal(size=LATENT) * 0.3).astype(np.float32),
         "texture": (rng.normal(size=LATENT) * 0.3).astype(np.float32)}
    apply_fn, composite_fn = j_codes_opt.build_fused_codes_fns(
        jhp, R, input_grads=True)
    assert apply_fn is not None and composite_fn is None
    pix_j = jnp.asarray(pix)
    uv = jnp.stack([(pix_j % W).astype(jnp.float32),
                    (pix_j // W).astype(jnp.float32)], -1)
    gt = jnp.asarray(image).reshape(-1, 3)[pix_j]

    def jloss(var):
        c2w_r = j_poses.refine_pose(var["xi"], jnp.asarray(c2w))
        ro_, vd_ = j_rays.pixel_rays(
            uv, jnp.full((R,), focal, jnp.float32),
            jnp.broadcast_to(c2w_r[:3, :], (R, 3, 4)), H, W)
        res = j_renderer.render_rays(
            jparams, jhp.net, jhp.render, ro_, vd_, var["shape"],
            var["texture"], render_key, fine_params=jfine,
            apply_fn=apply_fn)
        mse = jnp.mean((res.final.rgb - gt) ** 2)
        loss = mse + jnp.mean((res.coarse.rgb - gt) ** 2)
        reg = (j_codes_opt.safe_code_norm(var["shape"])
               + j_codes_opt.safe_code_norm(var["texture"]))
        return loss + jhp.loss_reg_coef * reg, mse

    (loss_w, mse_w), g_w = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(x) for k, x in v.items()})
    loss_fn = pose_opt.build_pose_loss(model, hp, _t(image), _t(c2w), focal,
                                       rays_per_step=R, fine_model=fine)
    leaves = {k: torch.from_numpy(x).requires_grad_(True)
              for k, x in v.items()}
    loss, mse = loss_fn(leaves["xi"], leaves["shape"], leaves["texture"],
                        None, pix=torch.from_numpy(pix), jitter=_t(jitter),
                        u=_t(u))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_w),
                               rtol=1e-3)
    np.testing.assert_allclose(float(mse), float(mse_w), rtol=1e-3)
    for name in ("xi", "shape", "texture"):
        rel = _rel(leaves[name].grad.numpy(), g_w[name])
        assert rel < 1e-2, (name, rel)


ROUTE_CONFIGS = {
    "coarse_fused": {},
    "coarse_plane": {"fused_composite": False},
    "hier_shared": {"N_importance": SF},
    "hier_separate": {"N_importance": SF,
                      "hierarchical_share_weights": False},
    "hier_separate_plane": {"N_importance": SF, "fused_composite": False,
                            "hierarchical_share_weights": False},
}


def _jax_route(fn):
    try:
        return fn()
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("name", list(ROUTE_CONFIGS))
def test_routes_match_jax(scene, name):
    """For each config, with ``use_fused_train`` on and off, each ray count
    (an exact split, 127×127 and 13×13 views that pad, counts that only the
    single pass tiles) and each ``use_fused``: the code-optimization and
    pose routes the JAX package takes (its single-pass predicates,
    ``codes_opt.py:250-268`` and ``pose_opt.py:89-98``, over
    ``build_fused_codes_fns``) against ``codes_route`` and ``pose_route``;
    and the training route and its refusals against ``build_train_step``."""
    H, W = scene["images"].shape[2:4]
    for fused in (True, False):
        cfg = _cfg(scene, fused, **ROUTE_CONFIGS[name])
        jhp, hp = j_hparams_from_dict(cfg), hparams_from_dict(cfg)
        hier = jhp.render.n_importance > 0
        for n, target in ((4096, 4096), (16129, 4096), (169, 64), (48, 64),
                          (8192, 4096)):
            chunk, n_chunks, _ = j_renderer.chunk_plan(n, target)
            for use_fused in (None, True, False):
                want_fused = fused if use_fused is None else use_fused

                def jax_codes():
                    if (want_fused and jhp.fused_composite
                            and (not hier or jhp.render.share_fine_weights)
                            and n_chunks * chunk == n
                            and j_ft.single_pass_available(jhp.net, chunk)):
                        return "single_pass"
                    if not want_fused:
                        return "autodiff"
                    a, c = j_codes_opt.build_fused_codes_fns(
                        jhp, chunk, use_fused=use_fused)
                    return ("plane_op_composite" if c is not None else
                            "plane_op" if a is not None else "autodiff")

                def jax_pose():
                    if (want_fused and jhp.fused_composite
                            and (not hier or jhp.render.share_fine_weights)
                            and j_ft.single_pass_available(jhp.net, n)):
                        return "single_pass"
                    a, _ = j_codes_opt.build_fused_codes_fns(
                        jhp, n, use_fused=use_fused, input_grads=True)
                    return "autodiff" if a is None else "plane_op"

                where = (name, fused, n, use_fused)
                assert _jax_route(lambda: codes_opt.codes_route(
                    hp, n, target, use_fused)) == _jax_route(jax_codes), where
                assert _jax_route(lambda: pose_opt.pose_route(
                    hp, n, use_fused)) == _jax_route(jax_pose), where
        # training: the single-pass loss or the plane op, and the batches
        # the plane op refuses (it tiles by 32, the single pass by 16)
        assert train_step.uses_single_pass_loss(hp) == (
            jhp.use_fused_train and jhp.fused_composite
            and (not hier or jhp.render.share_fine_weights))
        for batch in (64, 48):
            if train_step.uses_single_pass_loss(hp) and batch % 32:
                continue    # the port's single pass takes 16-ray multiples
            tx = _grad_recorder()
            j_raises = _jax_route(lambda: j_train_step.build_train_step(
                jhp, H, W, tx, batch_size=batch))
            t_raises = _jax_route(lambda: train_step.build_train_step(
                hp, H, W, batch_size=batch))
            assert (j_raises == "ValueError") == (t_raises == "ValueError"), (
                name, fused, batch)


def test_tiling_rules_and_chunk_plans_match_jax():
    jcfg = j_hparams_from_dict({"net_hyperparams": NET}).net
    cfg = hparams_from_dict({"net_hyperparams": NET}).net
    for W in (128, 256, 512):
        jc, tc = (dataclasses.replace(c, W=W) for c in (jcfg, cfg))
        for n in (16, 32, 48, 64, 96, 4096, 16129):
            assert fused_train.fused_train_available(tc, n, 24) == \
                j_ft.fused_train_available(jc, n, 24), (W, n)
            assert fused_train.single_pass_available(tc, n) == \
                j_ft.single_pass_available(jc, n), (W, n)
            assert fused_mlp.fused_available(tc, n, 24) == \
                j_fused_mlp.fused_available(jc, n, 24), (W, n)
    for n in (1, 169, 4096, 4225, 9216, 16129, 16384, 40000):
        for target in (64, 4096):
            assert renderer.chunk_plan(n, target) == \
                j_renderer.chunk_plan(n, target), (n, target)
