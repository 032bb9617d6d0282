"""The port's training step against the JAX package on the same seeded
inputs: the single-pass kernel's weight-gradient mode (plain version), one
step's gradients on both routes, the two-group AdamW update, microbatch
accumulation, the ray-batch pipeline, ``pixel_rays`` and the schedules.

Tolerances, each with its reason:

- kernel, plain version vs ``invoke_train_fused(weight_grads=True)`` in
  Pallas interpret mode: both round to bf16 at the same points and differ
  by f32 summation order, which flips an occasional bf16 rounding of an
  activation or a cotangent; ``se`` at rtol 1e-4, every cotangent and
  every dW/db at relative L2 below 5e-3 and the elementwise bar of
  ``test_torch_fused_train._close`` (1e-2 of the largest magnitude plus
  5e-3 relative). Measured: 3.2e-3 at most (enc_xyz's dW). The sigma
  head's sums ``Σ t·dsig`` and ``Σ dsig`` are the exception: at this
  random init their terms cancel ~15-25x, and one-ulp changes of 2% of
  ``sproj`` move them by 10-58% — so their elementwise bar takes its
  scale from the sums of the terms' magnitudes instead (measured: 5.3e-3
  of that scale at most);
- one step's gradients vs ``jax.grad`` of the plain XLA loss in f32: at
  least as close to it as the XLA bf16 path is (``rel_port <=
  1.5·rel_xla_bf16 + 1e-3``, the bar of
  ``test_torch_fused_train.py`` and of the JAX package's fused-kernel
  tests);
- AdamW vs optax: the same f32 formulas in another order, rtol 1e-5 and
  atol 1e-6 (a thousandth of the smallest lr, the size of one update);
- microbatches vs the whole batch: the cotangent scale differs by a power
  of two (exact in bf16), so only f32 summation order differs — relative
  error below 1e-5 — except for gradients rounded to bf16 once per
  microbatch, within one bf16 ulp (see the test);
- the pipeline: bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.core import rays as j_rays
from codenerf_tpu.core.render import composite as j_composite
from codenerf_tpu.data.pipeline import RayBatchPipeline as JPipeline
from codenerf_tpu.data.synthetic import synthetic_scene
from codenerf_tpu.models.codenerf import apply_codenerf, init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu.training import schedules as j_sched
from codenerf_tpu.training import train_step as j_train_step
from codenerf_tpu_torch.config import NetConfig, hparams_from_dict
from codenerf_tpu_torch.core import rays
from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import fused_train
from codenerf_tpu_torch.training import schedules, train_step
from codenerf_tpu_torch.training.state import trainables_from_jax


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched, raising=True)


R, S = 32, 24
NET = dict(shape_blocks=2, texture_blocks=1, W=256, num_xyz_freq=6,
           num_dir_freq=2, latent_dim=32)


def _close(got, want, name, terms=None):
    """The bar of ``test_torch_fused_train._close``. ``terms``: the sizes
    of the terms of a sum that cancels (the sigma head's), which then set
    the elementwise scale in place of the result's own magnitude."""
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


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_objects=3, n_views=4, H=16, W=16, seed=0)


def _hparams(scene, fused=True, **extra):
    """The same configuration in both packages."""
    cfg = {"net_hyperparams": NET, "N_samples": S,
           "near": float(scene["near"]), "far": float(scene["far"]),
           "use_fused_train": fused, **extra}
    return j_hparams_from_dict(cfg), hparams_from_dict(cfg)


def _jax_trainables(n_objects=3, latent=NET["latent_dim"]):
    jcfg = JNetConfig(**NET)
    tr = {"params": init_codenerf(jax.random.PRNGKey(0), jcfg),
          "shape_codes": init_codes(jax.random.PRNGKey(1), n_objects, latent),
          "texture_codes": init_codes(jax.random.PRNGKey(2), n_objects,
                                      latent)}
    return jax.tree_util.tree_map(np.asarray, tr)


def _batch(scene, seed=0, n=R):
    """A seeded expanded batch from the scene, and per-ray depths."""
    pipe = RayBatchPipeline(scene["images"], scene["poses"], scene["focals"],
                            seed=seed)
    b = pipe.sample(n)
    rng = np.random.default_rng(seed + 100)
    z = np.sort(rng.uniform(float(scene["near"]), float(scene["far"]),
                            (n, S)), axis=-1).astype(np.float32)
    return b, z


def test_plain_weight_grads_match_jax_kernel():
    """(a) train_fused(weight_grads=True), plain version, vs the JAX
    kernel in interpret mode: se, the three cotangents, every dW/db."""
    cfg = JNetConfig(**{**NET, "num_xyz_freq": 10, "num_dir_freq": 4,
                        "latent_dim": 256})
    jparams = init_codenerf(jax.random.PRNGKey(0), cfg)
    tcfg = NetConfig(**dataclasses.asdict(cfg))
    model = CodeNeRF(tcfg).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    rng = np.random.default_rng(3)
    ro = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.3, 2.2, (R, S)).astype(np.float32), axis=-1)
    sc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    ro8, vd8, zj, sproj, tproj, vcontrib = j_fused_mlp.prep_ray_operands(
        jparams, cfg, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(sc), jnp.asarray(tc))
    gt8 = j_fused_mlp._pad_lanes(jnp.asarray(gt), 8)
    scale = 1.0 / (R * 3.0)
    want = j_ft.invoke_train_fused(
        cfg, S, R, True, scale, ro8, vd8, zj, sproj, tproj, vcontrib, gt8,
        j_ft.flatten_params_f32(jparams, cfg), weight_grads=True)
    sigma_terms = []
    got = fused_train.train_fused_plain(
        tcfg, S, R, True, scale, _t(ro8), _t(vd8), _t(zj),
        _t(sproj, torch.bfloat16), _t(tproj, torch.bfloat16),
        _t(vcontrib, torch.bfloat16), _t(gt8),
        fused_train.flatten_params(model, tcfg), weight_grads=True,
        sigma_terms=sigma_terms)
    names = [f"{n}.{k}" for n, _, _ in fused_train.weight_shapes(tcfg)
             for k in ("w", "b")]
    terms = dict(zip(["sigma.w", "sigma.b"],
                     [x.numpy() for x in sigma_terms]))
    assert len(got) == len(want) == 4 + len(names)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    for g, w, name in zip(got[1:], want[1:],
                          ["d_sproj", "d_tproj", "d_vcontrib"] + names):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g.float().numpy(), w, name, terms.get(name))
    assert all(g.dtype == torch.float32 for g in got[4:])


def _jax_loss(jhp, batch, z, H, W, dtype):
    cfg, rcfg = jhp.net, jhp.render
    reg_coef = jhp.loss_reg_coef

    def loss(tr):
        obj = jnp.asarray(batch["obj"])
        sc, tc = tr["shape_codes"][obj], tr["texture_codes"][obj]
        ro, vd = j_rays.pixel_rays(jnp.asarray(batch["uv"]),
                                   jnp.asarray(batch["focal"]),
                                   jnp.asarray(batch["c2w"]), H, W)
        xyz = ro[:, None, :] + vd[:, None, :] * jnp.asarray(z)[..., None]
        sig, rgb = apply_codenerf(tr["params"], cfg, xyz, vd, sc, tc,
                                  compute_dtype=dtype)
        res = j_composite(sig, rgb, jnp.asarray(z), white_bg=rcfg.white_bg)
        mse = jnp.mean((res.rgb - jnp.asarray(batch["rgb"])) ** 2)
        reg = jnp.mean(jnp.linalg.norm(sc, axis=-1)
                       + jnp.linalg.norm(tc, axis=-1))
        return mse + reg_coef * reg
    return loss


def _port_grads(state):
    """The port's gradients in the JAX pytree's leaf order."""
    params = {}
    for name, lin in state.model.named_children():
        params[name] = {"b": lin.bias.grad.numpy(),
                        "w": lin.weight.grad.numpy().T}
    return {"params": params, "shape_codes": state.shape_codes.grad.numpy(),
            "texture_codes": state.texture_codes.grad.numpy()}


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("route", ["fused", "autodiff"])
def test_step_grads_match_jax_grad(scene, route):
    """(b) One step's gradients for every trainable, from the same
    trainables, batch and depths, against jax.grad of the plain loss."""
    jhp, hp = _hparams(scene, fused=route == "fused")
    jtr = _jax_trainables()
    batch, z = _batch(scene)
    H, W = scene["images"].shape[2:4]
    state = trainables_from_jax(jtr, hp, device="cpu")
    grad_fn = train_step.build_grad_fn(hp, H, W, batch_size=R)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    metrics = grad_fn(state, tb, z=torch.from_numpy(z))
    l32 = float(_jax_loss(jhp, batch, z, H, W, jnp.float32)(jtr))
    assert abs(float(metrics["loss"]) - l32) < 2e-3 * max(1.0, abs(l32))

    jtr_j = jax.tree_util.tree_map(jnp.asarray, jtr)
    g32 = jax.grad(_jax_loss(jhp, batch, z, H, W, jnp.float32))(jtr_j)
    g16 = jax.grad(_jax_loss(jhp, batch, z, H, W, jnp.bfloat16))(jtr_j)
    got = _port_grads(state)
    for key in ("params", "shape_codes", "texture_codes"):
        v32, v16, vp = _flat(g32[key]), _flat(g16[key]), _flat(got[key])
        assert vp.shape == v32.shape, key
        rel_xla = np.linalg.norm(v16 - v32) / (np.linalg.norm(v32) + 1e-12)
        rel_port = np.linalg.norm(vp - v32) / (np.linalg.norm(v32) + 1e-12)
        assert rel_port <= 1.5 * rel_xla + 1e-3, (key, rel_port, rel_xla)


@pytest.mark.parametrize("reset_every", [0, 2])
def test_adamw_update_matches_optax(scene, reset_every):
    """(c) Three two-group AdamW updates with step-halving every step
    (and, with ``reset_every``, the window-frozen lr and the Adam reset)
    against optax ``multi_transform`` on the same gradients."""
    extra = {"lr_schedule": [{"type": "step", "lr": 1e-3, "interval": 1},
                             {"type": "step", "lr": 1e-2, "interval": 1}],
             "reference_quirks": {"optimizer_reset_every": reset_every}}
    jhp, hp = _hparams(scene, **extra)
    jtr = _jax_trainables()
    state = trainables_from_jax(jtr, hp, device="cpu")
    tx = j_train_step.build_optimizer(jhp)
    params = jax.tree_util.tree_map(jnp.asarray, jtr)
    opt_state = tx.init(params)
    rng = np.random.default_rng(7)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), jtr)
        if reset_every and step % reset_every == 0:
            opt_state = j_train_step.reset_adam_state(opt_state)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, lin in state.model.named_children():
            lin.bias.grad = torch.from_numpy(grads["params"][name]["b"])
            lin.weight.grad = torch.from_numpy(
                np.ascontiguousarray(grads["params"][name]["w"].T))
        state.shape_codes.grad = torch.from_numpy(grads["shape_codes"])
        state.texture_codes.grad = torch.from_numpy(grads["texture_codes"])
        train_step.apply_update(state, hp)
    assert state.step == 3
    got = {"params": {n: {"b": lin.bias.detach().numpy(),
                          "w": lin.weight.detach().numpy().T}
                      for n, lin in state.model.named_children()},
           "shape_codes": state.shape_codes.detach().numpy(),
           "texture_codes": state.texture_codes.detach().numpy()}
    moved = np.abs(_flat(got) - _flat(jtr)).max()
    assert moved > 1e-3        # the updates are not vacuous
    np.testing.assert_allclose(_flat(got), _flat(params), rtol=1e-5,
                               atol=1e-6)


def _named_grads(state):
    return {**{n: p.grad.numpy() for n, p in state.model.named_parameters()},
            "shape_codes": state.shape_codes.grad.numpy(),
            "texture_codes": state.texture_codes.grad.numpy()}


@pytest.mark.parametrize("route", ["fused", "autodiff"])
def test_microbatched_grads_equal_whole_batch(scene, route):
    """(d) Two microbatches of 32 rays give the gradients and metrics of
    the whole 64-ray batch (32 rays is the smallest microbatch the fused
    routes take, as in the JAX package). A gradient that leaves through a
    bf16 cast is rounded once per microbatch (as in the JAX package): on
    the fused route the prologue's latent projections and enc_viewdir's
    viewdir rows, on the autodiff route every model weight — those agree
    to one bf16 ulp (relative L2 below 2^-8). The rest, the kernel's f32
    dW/db and both code tables among them, below 1e-5."""
    _, hp = _hparams(scene, fused=route == "fused")
    jtr = _jax_trainables()
    batch, z = _batch(scene, seed=4, n=2 * R)
    H, W = scene["images"].shape[2:4]
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = []
    for mb in (0, R):
        state = trainables_from_jax(jtr, hp, device="cpu")
        grad_fn = train_step.build_grad_fn(hp, H, W, microbatch_rays=mb,
                                           batch_size=2 * R)
        m = grad_fn(state, tb, z=torch.from_numpy(z))
        out.append((_named_grads(state), m))
    (g_all, m_all), (g_mb, m_mb) = out
    if route == "fused":
        rounded = {"shape_latent_0.weight", "shape_latent_1.weight",
                   "texture_latent_0.weight", "enc_viewdir.weight"}
    else:
        rounded = {n for n in g_all if n.endswith((".weight", ".bias"))}
    for name, want in g_all.items():
        rel = np.linalg.norm(g_mb[name] - want) / np.linalg.norm(want)
        assert rel < (2.0 ** -8 if name in rounded else 1e-5), (name, rel)
    for k in ("loss", "mse", "psnr", "reg"):
        np.testing.assert_allclose(float(m_mb[k]), float(m_all[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("crop", [False, True])
def test_pipeline_sample_bit_equal_to_jax(scene, compact, crop):
    """(e) The same seed and stream give the same batches, bit for bit."""
    args = (scene["images"], scene["poses"], scene["focals"])
    jp, tp = JPipeline(*args, seed=5), RayBatchPipeline(*args, seed=5)
    for _ in range(2):
        want = jp.sample(64, crop=crop, compact=compact)
        got = tp.sample(64, crop=crop, compact=compact)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = jp.sample(64, crop=crop, compact=compact,
                     rng=np.random.default_rng([5, 3]))
    got = tp.sample(64, crop=crop, compact=compact,
                    rng=np.random.default_rng([5, 3]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_prefetch_streams_match_jax_and_skip(scene):
    """Prefetch stream 0 is the JAX package's first stream; ``skip``
    continues it where a run stopped."""
    args = (scene["images"], scene["poses"], scene["focals"])
    jit = JPipeline(*args, seed=2).prefetch(32, compact=True)
    want = [next(jit) for _ in range(3)]
    jit.close()
    tp = RayBatchPipeline(*args, seed=2)
    it = tp.prefetch(32, compact=True)
    got = [next(it) for _ in range(3)]
    it.close()
    it = tp.prefetch(32, compact=True, stream_id=0, skip=2)
    got_skip = next(it)
    it.close()
    for g, w in zip(got + [got_skip], want + [want[2]]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_prefetch_forwards_worker_failure(scene):
    tp = RayBatchPipeline(scene["images"], scene["poses"], scene["focals"])

    def boom(batch):
        raise OSError("staging failed")

    it = tp.prefetch(8, transform=boom)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        next(it)
    it.close()


def test_expand_compact_batch_matches_expanded(scene):
    tp = RayBatchPipeline(scene["images"], scene["poses"], scene["focals"])
    rng_state = np.random.default_rng(9)
    compact = tp.sample(40, compact=True, rng=np.random.default_rng(9))
    full = tp.sample(40, rng=rng_state)
    tables = {k: torch.from_numpy(v) for k, v in tp.tables().items()}
    got = train_step.expand_compact_batch(
        {k: torch.from_numpy(v) for k, v in compact.items()}, tables)
    for k in full:
        np.testing.assert_array_equal(got[k].numpy(), full[k], err_msg=k)


def test_pixel_rays_match_jax():
    rng = np.random.default_rng(1)
    n = 20
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w[i, :, :3], c2w[i, :, 3] = q, rng.normal(size=3)
    uv = rng.integers(0, 16, (n, 2)).astype(np.float32)
    focal = rng.uniform(10, 30, n).astype(np.float32)
    ro, vd = rays.pixel_rays(torch.from_numpy(uv), torch.from_numpy(focal),
                             torch.from_numpy(c2w), 16, 16)
    jro, jvd = j_rays.pixel_rays(jnp.asarray(uv), jnp.asarray(focal),
                                 jnp.asarray(c2w), 16, 16)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vd.numpy(), np.asarray(jvd), rtol=1e-5,
                               atol=1e-5)


def test_schedules_match_jax():
    for step in (0, 1, 99, 100, 250, 999, 1000, 1001):
        np.testing.assert_allclose(
            schedules.step_halving(1e-3, 100)(step),
            float(j_sched.step_halving(1e-3, 100)(step)), rtol=1e-6)
        np.testing.assert_allclose(
            schedules.window_frozen_step_halving(1e-3, 100, 300)(step),
            float(j_sched.window_frozen_step_halving(1e-3, 100, 300)(step)),
            rtol=1e-6)


@pytest.mark.parametrize("extra", [
    {"N_importance": 8, "hierarchical_share_weights": False},
    {"N_importance": 8, "hierarchical_share_weights": False,
     "use_fused_train": False},
    {"N_importance": 8, "fused_composite": False},
    {"fused_composite": False}])
def test_unported_training_configs_raise(scene, extra):
    """Separate fine weights (either route) and the plane-op kernels are
    ported (their steps against JAX: tests/test_torch_plane_routes.py).
    What still raises on these configs is what the JAX package refuses: a
    batch the plane op cannot tile (it tiles by 32 rays)."""
    _, hp = _hparams(scene, **extra)
    train_step.build_train_step(hp, 16, 16, batch_size=R)
    if hp.use_fused_train:
        assert not train_step.uses_single_pass_loss(hp)
        with pytest.raises(ValueError, match="divisible by 32"):
            train_step.build_train_step(hp, 16, 16, batch_size=48)
    else:
        train_step.build_train_step(hp, 16, 16, batch_size=48)


def test_mesh_raises(scene):
    """A model (tensor-parallel) axis of 2 does not fit one process:
    ``mesh_from_flags`` raises JAX's layout ``ValueError`` before any
    process group exists (the model axis on 2 ranks:
    tests/test_torch_tensor_parallel.py)."""
    from codenerf_tpu_torch.parallel.mesh import mesh_from_flags

    with pytest.raises(ValueError,
                       match=r"^1 devices not divisible by model\*replica=2$"):
        mesh_from_flags("cpu", model=2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("rays", [16, 48, 32, 64])
@pytest.mark.parametrize("extra", [{}, {"fused_composite": False}],
                         ids=["single_pass", "plane_op"])
def test_ray_count_rule_matches_jax(scene, extra, rays):
    """Every fused route takes the ray counts the JAX package takes and
    refuses the others with ValueError: the plane-op pair's 32-ray rule,
    on the single pass as on the plane op (JAX
    ``build_train_step``), as a batch and as microbatches."""
    jhp, hp = _hparams(scene, **extra)
    assert train_step.uses_single_pass_loss(hp) == (not extra)
    for kw in (dict(batch_size=rays),
               dict(batch_size=2 * rays, microbatch_rays=rays)):
        try:
            j_train_step.build_train_step(jhp, 16, 16, optax.adam(1e-3),
                                          **kw)
            jax_raises = False
        except ValueError:
            jax_raises = True
        assert jax_raises == (rays % 32 != 0), (kw, jax_raises)
        if jax_raises:
            with pytest.raises(ValueError, match="divisible by 32"):
                train_step.build_train_step(hp, 16, 16, **kw)
        else:
            train_step.build_train_step(hp, 16, 16, **kw)


def test_fused_rejects_untileable_batch(scene):
    _, hp = _hparams(scene)
    with pytest.raises(ValueError, match="divisible"):
        train_step.build_train_step(hp, 16, 16, batch_size=40)
