"""Object-sharded code fitting and eval over a process mesh, and the
4-rank ``(replica=2, data=2)`` mesh, on the CPU (``gloo`` ranks spawned by
the tests, the kernels' plain versions). The port's counterparts of
``tests/test_sharding.py``'s ``test_three_axis_replica_mesh_matches_
single_device`` (without its model axis, which is
``test_torch_tensor_parallel.py``'s), a fit over a ``(data=2, model=2)``
mesh, ``test_batched_codes_opt_mesh_matches_single_device``,
``test_multi_object_eval_mesh_matches_single_device``,
``test_codes_opt_mesh_with_occupancy_and_stochastic`` and
``test_multi_object_eval_mesh_with_device_gt``.

Fitting uses ``test_torch_opt_rays_group.py``'s sizes (W=256, 2+1 blocks,
latent 32, 8 samples, 16×16 views, chunks of 128 rays). The bars are the
JAX tests': against the port's unsharded run, codes atol 1e-5 and PSNR
history atol 1e-3 (each object runs the same arithmetic on one rank),
eval PSNR 1e-3, SSIM 1e-4 and images 1e-4;
against the JAX package's unsharded fit on the same weights with both
samplers at the bin midpoints (no draw left), ``test_torch_opt_rays_
group.py``'s bars: history 0.02 dB and codes 1e-2 (bf16 on the port's
kernel route against JAX's f32 XLA route). The 4-rank training step holds
``test_torch_sharding.py``'s bars.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sharding import (ROUNDED, assert_matches, cfg_dict,
                                 flat_weights_start, load, spawn, train_run)

D = 32
FIT_CFG = {
    "net_hyperparams": {"shape_blocks": 2, "texture_blocks": 1, "W": 256,
                        "num_xyz_freq": 6, "num_dir_freq": 2,
                        "latent_dim": D},
    "N_samples": 8, "near": 2.2, "far": 5.8, "use_fused_train": True,
}
FIT = dict(num_opts=3, lr=1e-2, lr_half_interval=2)
CHUNK = 128


def _fit_scene(n_objects=3):
    from codenerf_tpu_torch.data.synthetic import synthetic_scene

    return synthetic_scene(n_objects=n_objects, n_views=3, H=16, W=16,
                           seed=3, pattern=True)


def _optimizer(model_sd, init, mesh=None, **kw):
    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer

    hp = hparams_from_dict(FIT_CFG)
    model = CodeNeRF(hp.net)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in model_sd.items()})
    s0, t0 = (torch.from_numpy(x) for x in init)
    return CodeOptimizer(model, hp, s0, t0, chunk=CHUNK, device="cpu",
                         mesh=mesh, **kw)


def _gens(seed, n):
    return [torch.Generator().manual_seed(seed + g) for g in range(n)]


def _sphere_grid():
    from codenerf_tpu_torch.core.occupancy import (OccupancyGrid,
                                                   grid_cell_centers)

    centers = grid_cell_centers(8, 1.4).reshape(8, 8, 8, 3)
    return OccupancyGrid(occ=torch.linalg.norm(centers, dim=-1) < 1.1,
                         radius=1.4)


def _gt_params():
    from codenerf_tpu_torch.data.synthetic import synthetic_scene

    sc = synthetic_scene(n_objects=4, n_views=3, H=16, W=16, seed=9,
                         pattern=True, geometry="chair", params_only=True)
    return sc, dict(geometry="chair", pattern=True, hw=(16, 16),
                    albedo=sc["albedos"], boxes=sc["boxes"], yaw=sc["yaws"])


def fit_cases(model_sd, init, mesh=None) -> dict:
    """Every fitting and eval case of this module, on ``mesh`` or on one
    process; the results by case."""
    out = {}
    scene = _fit_scene()
    args = (scene["images"], scene["poses"], scene["focals"], [0])
    opt = _optimizer(model_sd, init, mesh)
    res = opt.optimize_objects(*args, _gens(100, 3), **FIT)
    out["fit3"] = {"s": res.shape_codes.numpy(),
                   "t": res.texture_codes.numpy(), "hist": res.psnr_history}
    out["eval3"] = opt.evaluate_objects(*args[:3], [0], res.shape_codes,
                                        res.texture_codes, _gens(70, 3),
                                        return_images=True)
    occ = _optimizer(model_sd, init, mesh, occ_grid=_sphere_grid(),
                     opt_rays=48)
    s2 = _fit_scene(2)
    res = occ.optimize_objects(s2["images"], s2["poses"], s2["focals"], [0],
                               _gens(200, 2), **FIT)
    out["fit_occ_rays"] = {"s": res.shape_codes.numpy(),
                           "t": res.texture_codes.numpy(),
                           "hist": res.psnr_history}
    sc, gt = _gt_params()
    s0, t0 = (torch.from_numpy(x) for x in init)
    scs = torch.stack([s0 * (1 + 0.01 * g) for g in range(4)])
    tcs = torch.stack([t0 * (1 - 0.01 * g) for g in range(4)])
    out["eval_gt"] = opt.evaluate_objects(None, sc["poses"], sc["focals"],
                                          [0], scs, tcs, _gens(130, 4),
                                          gt_params=gt)
    return out


def _midpoints(generator, near, far, n_samples, num_rays=None,
               shared=False, jitter=None, device=None):
    half = (far - near) / (2.0 * n_samples)
    base = torch.linspace(near + half, far - half, n_samples, device=device)
    return base if num_rays is None else base.expand(num_rays, n_samples)


def midpoint_fit(model_sd, init, mesh=None) -> dict:
    """The 3-object fit with the coarse sampler at the bin midpoints."""
    from codenerf_tpu_torch import renderer

    orig = renderer.stratified_zvals
    renderer.stratified_zvals = _midpoints
    try:
        scene = _fit_scene()
        res = _optimizer(model_sd, init, mesh).optimize_objects(
            scene["images"], scene["poses"], scene["focals"], [0],
            _gens(0, 3), **FIT)
    finally:
        renderer.stratified_zvals = orig
    return {"s": res.shape_codes.numpy(), "t": res.texture_codes.numpy(),
            "hist": res.psnr_history}


def _save(out, name, rank, res):
    np.save(f"{out}/{name}_{rank}.npy", res, allow_pickle=True)


def _fit2_worker(rank, mesh, out, model_sd, init):
    _save(out, "fit", rank, fit_cases(model_sd, init, mesh))
    _save(out, "midpoints", rank, midpoint_fit(model_sd, init, mesh))


def _mesh4_worker(rank, mesh, out, model_sd, init, trainables):
    from codenerf_tpu_torch.parallel import mesh as pm

    facts = {"shard": pm.batch_shard(mesh),
             "group_rank": dist.get_rank(pm.batch_group(mesh)),
             "axes": pm.batch_axes(mesh), "names": mesh.mesh_dim_names}
    m2 = pm.make_mesh(model=2)
    facts["model2"] = {"names": m2.mesh_dim_names,
                       "shape": tuple(m2.mesh.shape),
                       "model": pm.model_size(m2),
                       "shard": pm.batch_shard(m2),
                       "model_rank": dist.get_rank(pm.model_group(m2))}
    try:
        pm.make_mesh(data=3)
    except ValueError as e:
        facts["data3"] = str(e)
    _save(out, "facts", rank, facts)
    _save(out, "train", rank, train_run(cfg_dict(), trainables, mesh,
                                        batch=128))
    scene = _fit_scene()
    res = _optimizer(model_sd, init, mesh).optimize_objects(
        scene["images"], scene["poses"], scene["focals"], [0],
        _gens(100, 3), **FIT)
    _save(out, "fit3", rank, {"s": res.shape_codes.numpy(),
                              "t": res.texture_codes.numpy(),
                              "hist": res.psnr_history})
    res = _optimizer(model_sd, init, m2).optimize_objects(
        scene["images"], scene["poses"], scene["focals"], [0],
        _gens(100, 3), **FIT)
    _save(out, "fit3_model2", rank, {"s": res.shape_codes.numpy(),
                                     "t": res.texture_codes.numpy(),
                                     "hist": res.psnr_history})


# ------------------------------------------------------------------ fixtures
@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """JAX-initialized weights: the fitting network as JAX params and as
    the port's state dict (numpy), a code init, and the training
    module's trainables."""
    import jax

    from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
    from codenerf_tpu.config import NetConfig as JNetConfig
    from codenerf_tpu.models.codenerf import init_codenerf
    from codenerf_tpu.models.codes import init_codes
    from codenerf_tpu_torch.models.codenerf import params_from_jax
    from test_torch_sharding import NET

    jhp = j_hparams_from_dict(FIT_CFG)
    jparams = init_codenerf(jax.random.PRNGKey(0), jhp.net)
    sd = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}
    rng = np.random.default_rng(5)
    init = tuple((rng.normal(size=D) * 0.1).astype(np.float32)
                 for _ in range(2))
    cfg = JNetConfig(**NET)
    tr = {"params": init_codenerf(jax.random.PRNGKey(0), cfg),
          "shape_codes": init_codes(jax.random.PRNGKey(1), 3, 32),
          "texture_codes": init_codes(jax.random.PRNGKey(2), 3, 32)}
    return (jhp, jparams, sd, init,
            jax.tree_util.tree_map(np.asarray, tr))


@pytest.fixture(scope="module")
def fit2(tmp_path_factory, nets):
    out = str(tmp_path_factory.mktemp("fit2"))
    spawn(_fit2_worker, 2, out, nets[2], nets[3])
    return out


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory, nets):
    out = str(tmp_path_factory.mktemp("mesh4"))
    spawn(_mesh4_worker, 4, out, nets[2], nets[3], nets[4])
    return out


@pytest.fixture(scope="module")
def unsharded(nets):
    return fit_cases(nets[2], nets[3])


def _same_fit(got, want):
    np.testing.assert_allclose(got["s"], want["s"], atol=1e-5)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-5)
    np.testing.assert_allclose(got["hist"], want["hist"], atol=1e-3)
    assert got["hist"].shape == want["hist"].shape


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("world", [2, 4])
def test_batched_fit_matches_unsharded(fit2, mesh4, unsharded, world):
    """3 objects fitted on 2 and on 4 ranks (padded to 4 rows either way;
    on 4 ranks one rank fits only the pad) equal the unsharded batched
    fit, on every rank, and the fit moved the codes."""
    want = unsharded["fit3"]
    for rank in range(world):
        got = (load(fit2, "fit", rank)["fit3"] if world == 2
               else load(mesh4, "fit3", rank))
        _same_fit(got, want)
    assert np.abs(want["s"][0] - want["s"][1]).max() > 1e-3


def test_sharded_eval_matches_unsharded(fit2, unsharded):
    """``evaluate_objects`` with the object axis split over 2 ranks scores
    every (object, view) as the unsharded sweep does, images included."""
    want = unsharded["eval3"]
    for rank in range(2):
        got = load(fit2, "fit", rank)["eval3"]
        np.testing.assert_array_equal(got["views"], want["views"])
        assert got["psnr"].shape == want["psnr"].shape == (3, 2)
        np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-3)
        np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-4)
        np.testing.assert_allclose(got["images"], want["images"], atol=1e-4)


def test_sharded_fit_with_occupancy_and_opt_rays(fit2, unsharded):
    """Sharded fitting with the occupancy grid and 48-ray minibatches
    (each object's own stream) equals the unsharded run."""
    for rank in range(2):
        _same_fit(load(fit2, "fit", rank)["fit_occ_rays"],
                  unsharded["fit_occ_rays"])


def test_sharded_eval_with_device_gt(fit2, unsharded):
    """Sharded eval on ground truth rendered from ``gt_params`` (its
    leaves split with their objects) equals the unsharded sweep."""
    want = unsharded["eval_gt"]
    for rank in range(2):
        got = load(fit2, "fit", rank)["eval_gt"]
        np.testing.assert_array_equal(got["views"], want["views"])
        assert got["psnr"].shape == (4, 2)
        np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-3)
        np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-4)


def test_sharded_fit_matches_jax(fit2, nets, monkeypatch):
    """The 2-rank fit against the JAX package's unsharded
    ``optimize_codes_batch`` on the same weights, both samplers at the
    bin midpoints."""
    import jax
    import jax.numpy as jnp

    import codenerf_tpu.renderer as j_renderer
    from codenerf_tpu.core.rays import camera_rays as j_camera_rays
    from codenerf_tpu.optimization import codes_opt as j_codes_opt

    jhp, jparams, _, init, _ = nets

    def j_midpoints(key, near, far, n_samples, num_rays=None, shared=False):
        half = (far - near) / (2.0 * n_samples)
        base = jnp.linspace(near + half, far - half, n_samples,
                            dtype=jnp.float32)
        return base if num_rays is None else jnp.broadcast_to(
            base, (num_rays, n_samples))

    monkeypatch.setattr(j_renderer, "stratified_zvals", j_midpoints)
    j_codes_opt._RUN_CACHE.clear()
    scene = _fit_scene()
    rays = [j_camera_rays(16, 16, float(scene["focals"][g]),
                          jnp.asarray(scene["poses"][g, 0]))
            for g in range(3)]
    gt = jnp.asarray(scene["images"][:, 0].reshape(3, -1, 3)
                     .astype(np.float32) / 255.0)
    want = j_codes_opt.optimize_codes_batch(
        jparams, jhp, jnp.stack([r[0] for r in rays]),
        jnp.stack([r[1] for r in rays]), gt, jnp.asarray(init[0]),
        jnp.asarray(init[1]),
        jnp.stack([jax.random.PRNGKey(g) for g in range(3)]),
        chunk=CHUNK, use_fused=False, **FIT)
    j_codes_opt._RUN_CACHE.clear()
    for rank in range(2):
        got = load(fit2, "midpoints", rank)
        assert np.abs(got["s"] - init[0]).max() > 1e-2
        np.testing.assert_allclose(got["hist"],
                                   np.asarray(want.psnr_history), atol=0.02)
        np.testing.assert_allclose(got["s"], np.asarray(want.shape_codes),
                                   atol=1e-2)
        np.testing.assert_allclose(got["t"], np.asarray(want.texture_codes),
                                   atol=1e-2)


def test_replica_data_mesh_matches_one_process(mesh4, nets):
    """A ``(replica=2, data=2)`` mesh on 4 ranks: the batch split 4 ways,
    replica-major (each rank's shard index is its rank in the batch
    group), and 3 single-pass steps of 128 rays (32 a rank) against one
    process; the ranks end on the same weights."""
    trainables = nets[4]
    facts = [load(mesh4, "facts", r) for r in range(4)]
    for r, f in enumerate(facts):
        assert f["names"] == ("replica", "data", "model")
        assert f["axes"] == ("replica", "data")
        assert f["shard"] == (r, 4) and f["group_rank"] == r
    got = [load(mesh4, "train", r) for r in range(4)]
    for g in got[1:]:
        np.testing.assert_array_equal(g["weights"], got[0]["weights"])
    want = train_run(cfg_dict(), trainables, batch=128)
    assert_matches(got[0], want, flat_weights_start({"coarse": trainables}),
                   ROUNDED)


def test_make_mesh_refusals(mesh4):
    """On 4 ranks ``make_mesh(model=2)`` builds JAX's ``(data=2,
    model=2)`` layout (rank-major: batch shard ``r // 2``, ``model`` rank
    ``r % 2``); ``make_mesh(data=3)`` raises JAX's ``ValueError``."""
    for r in range(4):
        f = load(mesh4, "facts", r)
        assert f["model2"] == {"names": ("data", "model"), "shape": (2, 2),
                               "model": 2, "shard": (r // 2, 2),
                               "model_rank": r % 2}
        assert f["data3"] == "replica*data*model=3 != device count 4"


def test_fit_on_model_axis_matches_unsharded(mesh4, unsharded):
    """``CodeOptimizer`` on the ``(data=2, model=2)`` mesh, as JAX's
    ``shard_map`` runs it: the frozen weights whole on every rank, the
    objects split over ``data`` alone, the two ranks of a ``model`` group
    fitting the same rows; every rank ends on the unsharded fit."""
    for rank in range(4):
        _same_fit(load(mesh4, "fit3_model2", rank), unsharded["fit3"])

