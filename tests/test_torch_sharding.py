"""Data-parallel training over a process mesh on the CPU
(``codenerf_tpu_torch/parallel/mesh.py``): ``gloo`` ranks spawned by the
tests, each on the kernels' plain versions. The port's counterparts of
``tests/test_sharding.py`` (which runs the JAX package on 8 virtual CPU
devices): ``test_mesh_construction``, ``test_data_parallel_matches_
single_device``, ``test_occupancy_step_with_mesh_matches_single_device``
and ``test_trainer_with_mesh``; the 4-rank mesh and code fitting are in
``test_torch_sharding_fit.py``, the CLIs in ``test_torch_sharding_cli.py``.

Sizes are those of ``test_torch_train_step.py`` (W=256, 2+1 blocks,
latent 32, 24 samples, 16×16 scene): 64 rays a step on one process, 32 a
rank on two. Each run is held two ways:

- against the port's one-process run of the same batches and depths,
  3 steps: the loss at every step within rtol 1e-4 (JAX's bar); the
  first step's gradients, from the same weights, at the bars of
  ``test_torch_train_step.py``'s microbatch test, for the same reason (a
  gradient that leaves through a bf16 cast is rounded once per shard:
  relative L2 below 2^-8; the rest differ in f32 summation order: below
  1e-5); the weights after 3 steps within JAX's elementwise bars (rtol
  2e-3, atol 1e-5) on the f32 route (``compute_dtype: float32``, the
  JAX test's configuration: measured 0 of 402,116 elements outside,
  relative L2 6e-7 of the update). The bf16 routes (the kernels' and
  autodiff in bf16) keep the weights within a relative L2 error of 2e-2
  of the 3 steps' update (measured 6.0e-3 to 7.9e-3): they round the
  weights to bf16, so a last-bit difference from step 1 can move a
  weight's bf16 value and every activation it feeds, and AdamW's first
  steps move every element by about lr whatever its gradient's size, so
  the 0.1-0.5% of elements whose gradient is near zero and changes sign
  move apart by up to 2·lr (measured up to 8.3e-4 at lr 5e-4). The
  occupancy step holds JAX's tighter bars (loss rtol 1e-5, ``enc_xyz.w``
  atol 1e-6) on the f32 route;
- against ``jax.grad`` of the JAX package's plain loss on the whole
  batch with the same explicit depths, at ``test_torch_train_step.py``'s
  bar (the port at least as close to the f32 gradient as XLA's bf16 path
  is).

Every rank's weights must be the same bits after every run.

Spawned workers re-import this module, so it imports no JAX at the top.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NET = dict(shape_blocks=2, texture_blocks=1, W=256, num_xyz_freq=6,
           num_dir_freq=2, latent_dim=32)
S, B, H = 24, 64, 16
STEPS = 3
ROUTES = {"single_pass": {}, "plane_op": {"fused_composite": False},
          "autodiff": {"use_fused_train": False},
          "autodiff_f32": {"use_fused_train": False,
                           "compute_dtype": "float32"}}
# The gradients that leave through a bf16 cast, rounded once per shard.
ROUNDED = {"shape_latent_0.weight", "shape_latent_1.weight",
           "texture_latent_0.weight", "enc_viewdir.weight"}


def _scene():
    from codenerf_tpu_torch.data.synthetic import synthetic_scene

    return synthetic_scene(n_objects=3, n_views=4, H=H, W=H, seed=0)


def cfg_dict(fused=True, **extra):
    """The test configuration, as a jsonfile dict."""
    scene = _scene()
    return {"net_hyperparams": NET, "N_samples": S,
            "near": float(scene["near"]), "far": float(scene["far"]),
            "lr_schedule": [{"type": "step", "lr": 5e-4, "interval": 100000},
                            {"type": "step", "lr": 5e-3, "interval": 100000}],
            "use_fused_train": fused, **extra}


def spawn(fn, world: int, out: str, *args) -> None:
    """``fn(rank, mesh, out, *args)`` in ``world`` spawned ``gloo``
    ranks joined through a file in ``out``; a failing rank fails the
    call."""
    mp.spawn(_rank_main, args=(world, out, fn, args), nprocs=world,
             join=True)


def _rank_main(rank, world, out, fn, args):
    from codenerf_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    pm.init_from_env("cpu", init_method=f"file://{out}/pg")
    try:
        mesh_kw = {"data": 2, "replica": 2} if world == 4 else {}
        fn(rank, pm.make_mesh(**mesh_kw), out, *args)
    finally:
        dist.destroy_process_group()


def whole(state, grads=False) -> dict:
    """Every trainable (or, ``grads``, its gradient) by name, whole: under
    a model axis gathered from the ranks' slices (every rank calls it)."""
    from codenerf_tpu_torch.training.state import named_trainables

    named = named_trainables(state)
    if grads:
        named = {n: p.grad for n, p in named.items()}
    if state.shards is not None:
        with torch.no_grad():
            named = state.shards.whole(named)
    return {n: t.detach().numpy().copy() for n, t in named.items()}


def flat_weights(state) -> np.ndarray:
    return np.concatenate([v.ravel() for v in whole(state).values()])


def _grads(state) -> dict:
    """The model's and the code tables' gradients by name, whole."""
    g = whole(state, grads=True)
    return {n.removeprefix("model."): v for n, v in g.items()
            if not n.startswith("fine_model.")}


def train_run(cfg, trainables, mesh=None, steps=STEPS, explicit=True,
              microbatch=0, occ=False, batch=B):
    """``steps`` training steps of the config from ``trainables`` (JAX
    numpy arrays) on the pipeline's batches (this rank's rows under a
    mesh), with explicit whole-batch depths (and importance probes) from a
    seeded numpy stream or, ``explicit=False``, the state's generator.
    Returns the losses, the first and the last step's gradients by name,
    the first step's depths, and the final weights, whole; on a model
    axis also the rank's own leaves (``local``: each trainable, its AdamW
    moments and the generator's state)."""
    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.core.occupancy import OccupancyGrid
    from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
    from codenerf_tpu_torch.parallel.mesh import batch_shard
    from codenerf_tpu_torch.training import train_step
    from codenerf_tpu_torch.training.state import trainables_from_jax

    hp = hparams_from_dict(cfg)
    scene = _scene()
    state = trainables_from_jax(trainables, hp, device="cpu", mesh=mesh)
    pipe = RayBatchPipeline(scene["images"], scene["poses"], scene["focals"],
                            seed=7)
    shard = None if mesh is None else batch_shard(mesh)
    grad_fn = train_step.build_grad_fn(hp, H, H, microbatch_rays=microbatch,
                                       batch_size=batch, mesh=mesh)
    grid = None
    if occ:
        g = torch.zeros((8, 8, 8), dtype=torch.bool)
        g[:, :, :4] = True
        grid = OccupancyGrid(occ=g, radius=1.3)
    rng = np.random.default_rng(11)
    out = {"loss": []}
    for step in range(steps):
        b = pipe.sample(batch, shard=shard)
        z = u = None
        if explicit:
            z = np.sort(rng.uniform(hp.render.near, hp.render.far,
                                    (batch, S)), axis=-1).astype(np.float32)
            if hp.render.n_importance:
                u = rng.uniform(0, 1 - 1e-6, (batch, hp.render.n_importance)
                                ).astype(np.float32)
        state.optimizer.zero_grad(set_to_none=True)
        m = grad_fn(state, {k: torch.from_numpy(v) for k, v in b.items()},
                    z=None if z is None else torch.from_numpy(z),
                    u=None if u is None else torch.from_numpy(u),
                    occ_grid=grid)
        if step in (0, steps - 1):
            out["grads" if step == 0 else "last_grads"] = _grads(state)
        if step == 0:
            out["z"] = z
        out["loss"].append(float(m["loss"]))
        train_step.apply_update(state, hp)
    w = whole(state)
    out["weights"] = np.concatenate([v.ravel() for v in w.values()])
    out["enc_xyz.w"] = w["model.enc_xyz.weight"]
    if state.shards is not None:
        out["whole"] = w
        out["local"] = _local_leaves(state)
    return out


def _local_leaves(state) -> dict:
    """This rank's own leaves: each trainable, its AdamW moments and step
    (``<name>/<key>``) and the generator's state; ``dims``, the split."""
    from codenerf_tpu_torch.training.state import named_trainables

    out = {"dims": dict(state.shards.dims)}
    for n, p in named_trainables(state).items():
        out[n] = p.detach().numpy().copy()
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"{n}/{k}"] = v.numpy().copy()
    out["generator"] = state.generator.get_state().numpy().copy()
    return out


def _save(out: str, name: str, rank: int, res: dict) -> None:
    np.save(os.path.join(out, f"{name}_{rank}.npy"), res, allow_pickle=True)


def load(out: str, name: str, rank: int) -> dict:
    return np.load(os.path.join(out, f"{name}_{rank}.npy"),
                   allow_pickle=True).item()


# ------------------------------------------------------------ the rank work
HIER = {"N_importance": 8, "hierarchical_share_weights": False}
OCC = {"bound_sphere_radius": 1.3, "train_occupancy": {"grid_size": 8},
       **ROUTES["autodiff_f32"]}


def _cases():
    """name -> (config extras, train_run kwargs, trainables key)."""
    cases = {r: (extra, {}, "coarse") for r, extra in ROUTES.items()}
    cases["occupancy"] = (OCC, dict(steps=1, explicit=False, occ=True),
                          "coarse")
    # Separate fine weights (the plane op on both networks), drawn depths
    # and probes, microbatches of 64 rays (32 a rank) in a 128-ray batch.
    cases["fine_microbatch"] = (HIER, dict(steps=2, explicit=False,
                                           microbatch=64, batch=128), "fine")
    return cases


def _trainer_cfg():
    """The autodiff route at W=64 with the occupancy grid refreshed every
    4 steps after a 4-step warm-up, checkpoints every 10 steps."""
    return cfg_dict(fused=False, net_hyperparams=dict(NET, W=64),
                    check_points=10, bound_sphere_radius=1.3,
                    train_occupancy={"grid_size": 8, "warmup": 4,
                                     "update_every": 4})


def _dp_worker(rank, mesh, out, trainables):
    for name, (extra, kw, which) in _cases().items():
        _save(out, name, rank, train_run(cfg_dict(**extra),
                                         trainables[which], mesh, **kw))
    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.training.trainer import Trainer

    hp, scene = hparams_from_dict(_trainer_cfg()), _scene()
    tr = Trainer("mesh", hp, batch_size=B, dataset=scene, exps_root=out,
                 check_iter=0, device="cpu", mesh=mesh)
    m = tr.training(iters_crop=0, iters_all=20, log_every=10)
    res = {"loss": m["loss"], "weights": flat_weights(tr.state),
           "occ": tr.occupancy_grid.occ.numpy().copy()}
    tr2 = Trainer("mesh", hp, batch_size=B, dataset=scene, exps_root=out,
                  check_iter=0, device="cpu", mesh=mesh)
    res["resumed"] = tr2.resume()
    res["resumed_step"] = tr2.state.step
    res["resumed_weights"] = flat_weights(tr2.state)
    m2 = tr2.training(iters_crop=0, iters_all=24, log_every=2)
    res["loss2"] = m2["loss"]
    res["weights2"] = flat_weights(tr2.state)
    _save(out, "trainer", rank, res)


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def trainables():
    """JAX-initialized trainables (numpy), coarse and with a fine net."""
    import jax

    from codenerf_tpu.config import NetConfig as JNetConfig
    from codenerf_tpu.models.codenerf import init_codenerf
    from codenerf_tpu.models.codes import init_codes

    cfg = JNetConfig(**NET)
    tr = {"params": init_codenerf(jax.random.PRNGKey(0), cfg),
          "shape_codes": init_codes(jax.random.PRNGKey(1), 3, 32),
          "texture_codes": init_codes(jax.random.PRNGKey(2), 3, 32)}
    fine = dict(tr, fine_params=init_codenerf(jax.random.PRNGKey(3), cfg))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"coarse": to_np(tr), "fine": to_np(fine)}


@pytest.fixture(scope="module")
def dp_out(tmp_path_factory, trainables):
    """Every two-rank case, run once."""
    out = str(tmp_path_factory.mktemp("dp2"))
    spawn(_dp_worker, 2, out, trainables)
    return out


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("world,kw", [
    (8, dict(data=4, model=2)), (8, dict(model=1)), (8, dict(data=3, model=2)),
    (8, dict(data=2, model=2, replica=2)), (8, dict(replica=2, model=1)),
    (8, dict(replica=3)), (8, dict(data=8)), (8, dict(data=4))])
def test_mesh_shape_matches_jax(world, kw):
    """``mesh_shape`` gives the JAX package's ``make_mesh`` layout on as
    many devices (``test_mesh_construction``), and its ``ValueError``."""
    import jax

    from codenerf_tpu.parallel.mesh import make_mesh as j_make_mesh
    from codenerf_tpu_torch.parallel.mesh import mesh_shape

    assert len(jax.devices()) == world
    try:
        want = j_make_mesh(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(world, **kw)
        assert str(got.value) == str(e)
        return
    shape, names = mesh_shape(world, **kw)
    assert names == tuple(want.axis_names)
    assert dict(zip(names, shape)) == dict(want.shape)


def assert_matches(got, want, start, rounded=(), f32=False):
    """The module docstring's bars: rank 0's run ``got`` against the
    one-process run ``want`` from the weights ``start``."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for name, g in want["grads"].items():
        rel = np.linalg.norm(got["grads"][name] - g) / np.linalg.norm(g)
        assert rel < (2.0 ** -8 if name in rounded else 1e-5), (name, rel)
    update = want["weights"] - start
    assert np.abs(update).max() > 1e-4           # not vacuous
    if f32:
        np.testing.assert_allclose(got["weights"], want["weights"],
                                   rtol=2e-3, atol=1e-5)
    else:
        rel = (np.linalg.norm(got["weights"] - want["weights"])
               / np.linalg.norm(update))
        assert rel < 2e-2, rel


@pytest.mark.parametrize("route", list(ROUTES))
def test_data_parallel_matches_one_process(dp_out, trainables, route):
    """Two ranks × 3 steps of each route against one process on the same
    batches and depths; the ranks end on the same weights."""
    want = train_run(cfg_dict(**ROUTES[route]), trainables["coarse"])
    got = [load(dp_out, route, r) for r in range(2)]
    np.testing.assert_array_equal(got[0]["weights"], got[1]["weights"])
    rounded = {"single_pass": ROUNDED, "plane_op": ROUNDED,
               "autodiff": set(want["grads"]) - {"shape_codes",
                                                 "texture_codes"},
               "autodiff_f32": ()}[route]
    assert_matches(got[0], want, flat_weights_start(trainables), rounded,
                   f32=route == "autodiff_f32")


def flat_weights_start(trainables, which="coarse", **extra) -> np.ndarray:
    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.training.state import trainables_from_jax

    return flat_weights(trainables_from_jax(
        trainables[which], hparams_from_dict(cfg_dict(**extra)),
        device="cpu"))


def _jax_loss(jhp, batch, z, dtype):
    import jax.numpy as jnp

    from codenerf_tpu.core import rays as j_rays
    from codenerf_tpu.core.render import composite as j_composite
    from codenerf_tpu.models.codenerf import apply_codenerf

    cfg, rcfg = jhp.net, jhp.render

    def loss(tr):
        obj = jnp.asarray(batch["obj"])
        sc, tc = tr["shape_codes"][obj], tr["texture_codes"][obj]
        ro, vd = j_rays.pixel_rays(jnp.asarray(batch["uv"]),
                                   jnp.asarray(batch["focal"]),
                                   jnp.asarray(batch["c2w"]), H, H)
        xyz = ro[:, None, :] + vd[:, None, :] * jnp.asarray(z)[..., None]
        sig, rgb = apply_codenerf(tr["params"], cfg, xyz, vd, sc, tc,
                                  compute_dtype=dtype)
        res = j_composite(sig, rgb, jnp.asarray(z), white_bg=rcfg.white_bg)
        mse = jnp.mean((res.rgb - jnp.asarray(batch["rgb"])) ** 2)
        reg = jnp.mean(jnp.linalg.norm(sc, axis=-1)
                       + jnp.linalg.norm(tc, axis=-1))
        return mse + jhp.loss_reg_coef * reg
    return loss


@pytest.mark.parametrize("route", list(ROUTES))
def test_data_parallel_grads_match_jax(dp_out, trainables, route):
    """The first step's all-reduced gradients against ``jax.grad`` of the
    JAX package's plain loss on the whole batch at the same depths."""
    import jax
    import jax.numpy as jnp

    from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
    from codenerf_tpu_torch.data.pipeline import RayBatchPipeline

    jhp = j_hparams_from_dict(cfg_dict(**ROUTES[route]))
    got = load(dp_out, route, 0)
    scene = _scene()
    batch = RayBatchPipeline(scene["images"], scene["poses"],
                             scene["focals"], seed=7).sample(B)
    jtr = jax.tree_util.tree_map(jnp.asarray, trainables["coarse"])
    g32 = jax.grad(_jax_loss(jhp, batch, got["z"], jnp.float32))(jtr)
    g16 = jax.grad(_jax_loss(jhp, batch, got["z"], jnp.bfloat16))(jtr)
    port = got["grads"]
    names = [n for n in port if n not in ("shape_codes", "texture_codes")]
    mine = {"params": np.concatenate([
        (port[n].T if n.endswith("weight") else port[n]).ravel()
        for n in sorted(names, key=_jax_order)])}
    for key in ("shape_codes", "texture_codes"):
        mine[key] = port[key].ravel()

    def flat(tree):
        return np.concatenate([np.asarray(x, np.float32).ravel()
                               for x in jax.tree_util.tree_leaves(tree)])

    for key in ("params", "shape_codes", "texture_codes"):
        v32, v16 = flat(g32[key]), flat(g16[key])
        rel_xla = np.linalg.norm(v16 - v32) / np.linalg.norm(v32)
        rel_port = np.linalg.norm(mine[key] - v32) / np.linalg.norm(v32)
        assert rel_port <= 1.5 * rel_xla + 1e-3, (key, rel_port, rel_xla)


def _jax_order(name: str):
    """A port parameter name's place among the JAX pytree's leaves:
    layers by name, then ``b`` before ``w``."""
    layer, kind = name.rsplit(".", 1)
    return layer, kind != "bias"


def test_occupancy_step_matches_one_process(dp_out, trainables):
    """One step under a half-occupied grid with the generator's depths
    (drawn for the whole batch, each rank keeping its rows): JAX's bars,
    loss rtol 1e-5 and ``enc_xyz.w`` atol 1e-6."""
    want = train_run(cfg_dict(**OCC), trainables["coarse"], steps=1,
                     explicit=False, occ=True)
    got = [load(dp_out, "occupancy", r) for r in range(2)]
    np.testing.assert_array_equal(got[0]["weights"], got[1]["weights"])
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["enc_xyz.w"], want["enc_xyz.w"],
                               atol=1e-6)


def test_fine_network_microbatches_match_one_process(dp_out, trainables):
    """Separate fine weights (the plane op on each network) with
    microbatches of 32 rays a rank, the depths and importance probes drawn
    from the generator: 2 steps equal one process's."""
    want = train_run(cfg_dict(**HIER), trainables["fine"], steps=2,
                     explicit=False, microbatch=64, batch=128)
    got = [load(dp_out, "fine_microbatch", r) for r in range(2)]
    np.testing.assert_array_equal(got[0]["weights"], got[1]["weights"])
    assert_matches(got[0], want, flat_weights_start(trainables, "fine",
                                                    **HIER), ROUNDED)


def test_trainer_with_mesh(dp_out):
    """``Trainer(mesh=...)`` on two ranks, 20 steps with the occupancy
    grid refreshed every 4: a finite loss, the same weights and grid on
    both ranks, one writer (``metrics.jsonl`` has each logged step once,
    the checkpoints are the writer's), and a resume that restores step 20
    on both ranks and goes on alike."""
    got = [load(dp_out, "trainer", r) for r in range(2)]
    assert np.isfinite(got[0]["loss"])
    for key in ("weights", "occ", "resumed_weights", "weights2"):
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    np.testing.assert_array_equal(got[0]["weights"], got[0]["resumed_weights"])
    assert [g["resumed"] for g in got] == [True, True]
    assert [g["resumed_step"] for g in got] == [20, 20]
    run = os.path.join(dp_out, "mesh")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f
                 if "loss/train" in line]
    assert steps == [10, 20, 22, 24]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "step_00000010.pt", "step_00000020.pt", "step_00000024.pt"]
