"""Pose optimization in the port against the JAX package, on the CPU:

- one step of the single-pass route, coarse and hierarchical (sphere
  bounds, 16 + 16 samples), against the same chain of JAX package
  functions (``codenerf_tpu/optimization/pose_opt.py:144-229``: the
  prologue ``vjp``, ``invoke_train_fused(input_grads=True)`` in Pallas
  interpret mode, ``hier_fine_zvals`` and its ``vjp``) on the same pixel
  indices, coarse jitter and importance probes;
- the fine call's depth cotangent reaching the coarse depths through the
  union sort alone;
- three steps of the single-pass route against the autodiff route on the
  same draws (the bars of ``tests/test_fused_train.py::
  test_pose_opt_fused_matches_xla``);
- the pose-only gate against ``optax.multi_transform`` on fed gradients
(the CLIs: ``tests/test_torch_pose_cli.py``).

Tolerances, each with its reason: the loss and the MSE within 1e-3
relative and the gradients of ``xi``, the shape and the texture code
within 1e-2 relative L2 (both packages round to bf16 at the same points
and differ by f32 summation order, through a prologue that rounds to
bf16: the bar of ``tests/test_torch_hier.py``); the union-sort cotangent
exact (a permutation); the optimizer against optax within 1e-5 relative
(f32 Adam arithmetic in another order), the gated codes exact.
"""


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
from codenerf_tpu.optimization.codes_opt import \
    safe_code_norm as j_safe_code_norm
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu.training.schedules import step_halving as j_step_halving
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.core.poses import exp_se3
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import fused_train
from codenerf_tpu_torch.optimization import pose_opt

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


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_objects=2, n_views=3, H=16, W=16, seed=4)


def _cfg(scene, hier: bool, fused: bool = True, **extra):
    cfg = {"net_hyperparams": NET, "N_samples": SC,
           "near": float(scene["near"]), "far": float(scene["far"]),
           "use_fused_train": fused, **extra}
    if hier:
        cfg.update(N_importance=SF, bound_sphere_radius=1.4)
    return cfg


@pytest.fixture(scope="module")
def models():
    jparams = init_codenerf(jax.random.PRNGKey(1),
                            j_hparams_from_dict({"net_hyperparams": NET}).net)
    model = CodeNeRF(hparams_from_dict({"net_hyperparams": NET}).net)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    return jparams, model.requires_grad_(False)


def _draws(hp, image_c2w, focal, seed):
    """Pixel indices (numpy), the render key, and the coarse jitter and
    fine probes that ``coarse_zvals`` and ``sample_pdf`` draw from it in
    JAX. The pixels are those whose rays cross the bounding sphere well
    (its JAX bounds have a NaN gradient for a ray that misses, the
    port's a zero one; every ray of an SRN camera, inside the sphere,
    hits)."""
    ro, vd = j_rays.camera_rays(16, 16, focal, jnp.asarray(image_c2w))
    b = jnp.sum(ro * vd, -1)
    disc = np.asarray(b * b - (jnp.sum(ro * ro, -1) - 1.4 ** 2))
    pix = np.random.default_rng(seed).choice(np.flatnonzero(disc > 0.2), R)
    render_key = jax.random.PRNGKey(seed)
    key_z, key_fine = jax.random.split(render_key)
    jitter = j_sampling._uniform01_u8(key_z, R, hp.render.n_samples)
    u = jax.random.uniform(key_fine, (R, SF), dtype=jnp.float32,
                           maxval=1.0 - 1e-6)
    return pix, render_key, jitter, u


def _jax_step(jparams, jhp, image, c2w, focal, variables, pix, render_key):
    """The single-pass pose step of the JAX package, assembled from its
    public functions: loss, fine MSE and the gradients of
    ``variables``."""
    net_cfg, rcfg = jhp.net, jhp.render
    H, W = image.shape[:2]
    f32 = jnp.float32
    hier = rcfg.n_importance > 0
    scale = 1.0 / (R * 3.0)
    wflat = [jax.lax.stop_gradient(w)
             for w in j_ft.flatten_params_f32(jparams, net_cfg)]
    pix = jnp.asarray(pix)
    uv = jnp.stack([(pix % W).astype(f32), (pix // W).astype(f32)], -1)
    gt8 = j_fused_mlp._pad_lanes(image.reshape(-1, 3)[pix], 8)
    focal_b = jnp.full((R,), focal, f32)

    def prologue(v):
        c2w_r = j_poses.refine_pose(v["xi"], c2w)
        ro, vd = j_rays.pixel_rays(
            uv, focal_b, jnp.broadcast_to(c2w_r[:3, :], (R, 3, 4)), H, W)
        z2d, _ = j_renderer.coarse_zvals(rcfg, ro, vd, render_key)
        return j_fused_mlp.prep_ray_operands(jparams, net_cfg, ro, vd, z2d,
                                             v["shape"], v["texture"])

    ops6, pvjp = jax.vjp(prologue, variables)
    ro8, vd8, z2d, sproj, tproj, vcontrib = ops6
    outs = j_ft.invoke_train_fused(
        net_cfg, z2d.shape[1], R, rcfg.white_bg, scale, *ops6, gt8, wflat,
        want_weights=hier, weight_grads=False, input_grads=True)
    se_c, d_sproj, d_tproj, d_vcontrib = outs[:4]
    d_ro8, d_vd8, d_z = outs[-3:]
    mse = loss_se = se_c * scale
    if hier:
        key_fine = jax.random.split(render_key)[1]
        z_all, zvjp = jax.vjp(lambda z_: j_ft.hier_fine_zvals(
            z_, outs[4], key_fine, rcfg.n_importance), z2d)
        (se_f, d_sproj_f, d_tproj_f, d_vcontrib_f, d_ro8_f, d_vd8_f,
         d_z_all) = j_ft.invoke_train_fused(
            net_cfg, z_all.shape[1], R, rcfg.white_bg, scale, ro8, vd8,
            z_all, sproj, tproj, vcontrib, gt8, wflat, weight_grads=False,
            input_grads=True)
        d_sproj = j_ft.add_cotangent(d_sproj, d_sproj_f)
        d_tproj = j_ft.add_cotangent(d_tproj, d_tproj_f)
        d_vcontrib = j_ft.add_cotangent(d_vcontrib, d_vcontrib_f)
        d_ro8, d_vd8 = d_ro8 + d_ro8_f, d_vd8 + d_vd8_f
        d_z = d_z + zvjp(d_z_all)[0]
        mse = se_f * scale
        loss_se = (se_c + se_f) * scale
    (g,) = pvjp((d_ro8, d_vd8, d_z, d_sproj, d_tproj, d_vcontrib))

    def reg_fn(v):
        return j_safe_code_norm(v["shape"]) + j_safe_code_norm(v["texture"])

    reg, g_reg = jax.value_and_grad(reg_fn)(variables)
    grads = jax.tree_util.tree_map(lambda a, b: a + jhp.loss_reg_coef * b,
                                   g, g_reg)
    return loss_se + jhp.loss_reg_coef * reg, mse, grads


def _variables(seed):
    rng = np.random.default_rng(seed)
    return {"xi": (rng.normal(size=6) * 0.02).astype(np.float32),
            "shape": (rng.normal(size=LATENT) * 0.3).astype(np.float32),
            "texture": (rng.normal(size=LATENT) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("hier", [False, True], ids=["coarse", "hier"])
def test_pose_step_matches_jax(scene, models, hier):
    jparams, model = models
    cfg = _cfg(scene, hier)
    jhp, hp = j_hparams_from_dict(cfg), hparams_from_dict(cfg)
    image = scene["images"][0, 1].astype(np.float32) / 255.0
    c2w = scene["poses"][0, 1].astype(np.float32)
    focal = float(scene["focals"][0])
    v = _variables(2)
    pix, render_key, jitter, u = _draws(jhp, c2w, focal, seed=5)
    loss_w, mse_w, g_w = _jax_step(
        jparams, jhp, jnp.asarray(image), jnp.asarray(c2w), focal,
        {k: jnp.asarray(x) for k, x in v.items()}, pix, render_key)

    loss_fn = pose_opt.build_pose_loss(model, hp, _t(image), _t(c2w), focal,
                                       rays_per_step=R)
    leaves = {k: torch.from_numpy(x).requires_grad_(True)
              for k, x in v.items()}
    loss, mse = loss_fn(leaves["xi"], leaves["shape"], leaves["texture"],
                        None, pix=torch.from_numpy(pix), jitter=_t(jitter),
                        u=_t(u))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_w),
                               rtol=1e-3)
    np.testing.assert_allclose(float(mse), float(mse_w), rtol=1e-3)
    if hier:
        assert float(loss.detach()) > 1.5 * float(mse)   # coarse + fine
    for name in ("xi", "shape", "texture"):
        got, want = leaves[name].grad.numpy(), np.asarray(g_w[name])
        assert np.isfinite(got).all() and np.abs(want).max() > 0, name
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-2, (name, rel)


def test_fine_depth_cotangent_reaches_coarse_depths_through_the_sort():
    """``hier_fine_zvals``'s backward: the union's cotangent lands on the
    coarse depths it came from, and nowhere else (the importance samples
    are constants) — exactly as JAX's vjp of the same function."""
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(1.0, 3.0, (R, SC)), -1).astype(np.float32)
    w = rng.exponential(1.0, (R, SC)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    u = jax.random.uniform(key, (R, SF), dtype=jnp.float32,
                           maxval=1.0 - 1e-6)
    g_all = rng.normal(size=(R, SC + SF)).astype(np.float32)
    z_all_w, zvjp = jax.vjp(lambda z_: j_ft.hier_fine_zvals(
        z_, jnp.asarray(w), key, SF), jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    z_all = fused_train.hier_fine_zvals(zt, _t(w), None, SF, u=_t(u))
    # (the depths themselves: tests/test_torch_hier.py; the permutation,
    # on which the cotangent depends, is the same)
    z_all.backward(torch.from_numpy(g_all))
    want = np.asarray(zvjp(jnp.asarray(g_all))[0])
    np.testing.assert_array_equal(zt.grad.numpy(), want)
    # each coarse depth receives its own union slot's cotangent
    slot = np.argmax(np.asarray(z_all_w)[:, None, :] == z[:, :, None], -1)
    np.testing.assert_array_equal(want, np.take_along_axis(g_all, slot, 1))


@pytest.mark.parametrize("hier", [False, True], ids=["coarse", "hier"])
def test_single_pass_and_autodiff_routes_agree(scene, models, hier):
    """Three steps of each route on the same draws (one seeded generator,
    drawn in the same order): PSNR within 0.3 dB, ``xi`` within 5e-2 (the
    JAX test's bars). And one step's gradients of ``xi`` and the codes:
    the single-pass route at least as close to the autodiff route in f32
    as the autodiff route in bf16 is (``rel <= 1.5·rel_bf16 + 1e-3``)."""
    _, model = models
    image = _t(scene["images"][1, 0].astype(np.float32) / 255.0)
    c2w = _t(scene["poses"][1, 0])
    grads = {}
    for name, fused, dtype in (("fused", True, "bfloat16"),
                               ("bf16", False, "bfloat16"),
                               ("f32", False, "float32")):
        hp = hparams_from_dict(_cfg(scene, hier, fused=fused,
                                    compute_dtype=dtype))
        loss_fn = pose_opt.build_pose_loss(model, hp, image, c2w,
                                           float(scene["focals"][1]), 64)
        v = [torch.from_numpy(x).requires_grad_(True)
             for x in _variables(1).values()]
        loss, _ = loss_fn(*v, torch.Generator().manual_seed(1))
        loss.backward()
        grads[name] = [x.grad for x in v]
    for i, name in enumerate(["xi", "shape", "texture"]):
        ref = grads["f32"][i]
        rel = {k: float((grads[k][i] - ref).norm() / ref.norm())
               for k in ("fused", "bf16")}
        assert rel["fused"] <= 1.5 * rel["bf16"] + 1e-3, (name, rel)
    hp_f = hparams_from_dict(_cfg(scene, hier, fused=True))
    hp_a = hparams_from_dict(_cfg(scene, hier, fused=False))
    assert pose_opt.pose_route(hp_f, 64) == "single_pass"
    assert pose_opt.pose_route(hp_a, 64) == "autodiff"
    init = torch.zeros(LATENT)
    res = {}
    for name, hp in (("fused", hp_f), ("autodiff", hp_a)):
        res[name] = pose_opt.optimize_pose_and_codes(
            model, hp, image, c2w, float(scene["focals"][1]), init, init,
            torch.Generator().manual_seed(0), num_opts=3, lr_codes=1e-2,
            lr_pose=1e-2, lr_half_interval=2, rays_per_step=64)
    f, a = res["fused"], res["autodiff"]
    assert np.isfinite(f.psnr_history).all() and f.psnr_history.shape == (3,)
    assert torch.isfinite(f.xi).all() and float(f.xi.abs().max()) > 1e-3
    np.testing.assert_allclose(f.psnr_history, a.psnr_history, atol=0.3)
    np.testing.assert_allclose(f.xi.numpy(), a.xi.numpy(), atol=5e-2)
    torch.testing.assert_close(f.c2w, exp_se3(f.xi) @ c2w)


def _adam_moments(state):
    """The ``ScaleByAdamState`` s inside an optax state, in tree order."""
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):   # namedtuple states too
            for y in x:
                walk(y)
    walk(state)
    return found


def test_pose_only_gate_matches_optax():
    """Fed gradients, two pose-only steps then two joint ones: ``xi``
    moves as optax's Adam moves it; the codes stay exactly in place while
    their AdamW moments match optax's, then move as optax moves them."""
    hp = hparams_from_dict({"net_hyperparams": NET, "weight_decay": 0.05})
    rng = np.random.default_rng(4)
    sc0 = rng.normal(size=LATENT).astype(np.float32)
    tc0 = rng.normal(size=LATENT).astype(np.float32)
    lr_c, lr_p, half, gate = 1e-2, 2e-2, 2, 2
    state = pose_opt.make_pose_state(hp, _t(sc0), _t(tc0), lr_codes=lr_c,
                                     lr_pose=lr_p, lr_half_interval=half)
    tx = optax.multi_transform(
        {"pose": optax.adam(j_step_halving(lr_p, half)),
         "codes": optax.adamw(j_step_halving(lr_c, half),
                              weight_decay=hp.weight_decay)},
        {"xi": "pose", "shape": "codes", "texture": "codes"})
    jv = {"xi": jnp.zeros(6), "shape": jnp.asarray(sc0),
          "texture": jnp.asarray(tc0)}
    opt_state = tx.init(jv)
    for step in range(4):
        grads = {k: rng.normal(size=np.shape(x)).astype(np.float32)
                 for k, x in jv.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state, jv)
        code_gate = float(step >= gate)
        updates = {"xi": updates["xi"], "shape": updates["shape"] * code_gate,
                   "texture": updates["texture"] * code_gate}
        jv = optax.apply_updates(jv, updates)
        for name, p in (("xi", state.xi), ("shape", state.shape),
                        ("texture", state.texture)):
            p.grad = torch.from_numpy(grads[name])
        pose_opt.apply_pose_update(state, step, pose_only_steps=gate)
        np.testing.assert_allclose(state.xi.detach().numpy(),
                                   np.asarray(jv["xi"]), rtol=1e-5,
                                   atol=1e-7)
        for name, p in (("shape", state.shape), ("texture", state.texture)):
            if step < gate:
                np.testing.assert_array_equal(p.detach().numpy(),
                                              {"shape": sc0,
                                               "texture": tc0}[name])
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jv[name]), rtol=1e-5,
                                       atol=1e-7)
        assert float(state.xi.detach().abs().max()) > 0
    codes_m, pose_m = _adam_moments(opt_state)   # labels in sorted order
    adamw = state.opt_codes.state
    for name, p in (("shape", state.shape), ("texture", state.texture)):
        np.testing.assert_allclose(adamw[p]["exp_avg"].numpy(),
                                   np.asarray(codes_m.mu[name]), rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(adamw[p]["exp_avg_sq"].numpy(),
                                   np.asarray(codes_m.nu[name]), rtol=1e-5,
                                   atol=1e-10)
    np.testing.assert_allclose(
        state.opt_pose.state[state.xi]["exp_avg"].numpy(),
        np.asarray(pose_m.mu["xi"]), rtol=1e-5, atol=1e-8)


def test_routes_the_port_does_not_have_raise(scene):
    """Every route is ported: the plane op takes ``fused_composite:
    false`` and separate fine weights where it tiles the rays (32), and
    elsewhere the JAX package's quiet fallback to autodiff — or, with
    ``use_fused=True``, its ``ValueError`` (the route against JAX:
    tests/test_torch_plane_routes.py)."""
    for extra in ({"fused_composite": False},
                  {"N_importance": 8, "hierarchical_share_weights": False}):
        hp = hparams_from_dict(_cfg(scene, False, **extra))
        assert pose_opt.pose_route(hp, 64) == "plane_op"
        assert pose_opt.pose_route(hp, 48) == "autodiff"
        with pytest.raises(ValueError, match="can't tile"):
            pose_opt.pose_route(hp, 48, use_fused=True)
    assert pose_opt.pose_route(hparams_from_dict(_cfg(scene, False)),
                               40) == "autodiff"
