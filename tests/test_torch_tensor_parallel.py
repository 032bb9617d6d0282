"""Tensor parallelism: a ``model`` axis above 1 on the autodiff training
route (``codenerf_tpu_torch/parallel/mesh.py``), on the CPU over spawned
``gloo`` ranks at ``test_torch_sharding.py``'s sizes (W=256, 2+1 blocks,
24 samples, a 16×16 scene, one thread a rank) with latent 256, so that
the code tables are sharded too. The port's counterparts of
``tests/test_sharding.py``'s ``test_tensor_parallel_matches_single_
device`` and ``test_three_axis_replica_mesh_matches_single_device``:

- the shard plan against the JAX package's ``state_shardings``, leaf for
  leaf (no spawn);
- ``(data=1, model=2)`` on 2 ranks: every rank runs one process's
  arithmetic, so 3 steps give one process's losses, gathered gradients
  and gathered weights bit for bit (the one-process run is made on rank 0,
  at the same thread count), on the bf16 and f32 routes, hierarchical
  sampling with a shared and with a separate fine network, microbatches;
  replicated leaves are the same bits on both ranks;
- ``(replica=2, data=2, model=2)`` on 8 ranks against one process and
  ``jax.grad`` at ``test_torch_sharding.py``'s bars;
- checkpoints: whole on disk, resumed across one process ↔ ``model = 2``
  (the ``Trainer`` with its occupancy grid and render log under the
  axis), and read by ``load_run``;
- a fused config with ``model = 2`` raises JAX's ``ValueError``.

Spawned workers re-import this module, so it imports no JAX at the top.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_sharding import (B, H, NET, _jax_loss, _jax_order, _scene,
                                 assert_matches, cfg_dict, load, train_run,
                                 whole)

NET256 = dict(NET, latent_dim=256)
ROUTES = {"autodiff": {"use_fused_train": False},
          "autodiff_f32": {"use_fused_train": False,
                           "compute_dtype": "float32"}}
HIER_SHARED = {"N_importance": 8, "use_fused_train": False}
HIER_FINE = dict(HIER_SHARED, hierarchical_share_weights=False)


def cfg(**extra) -> dict:
    return cfg_dict(net_hyperparams=NET256, **extra)


def _cases():
    """name -> (config extras, train_run kwargs, trainables key)."""
    cases = {r: (extra, {}, "coarse") for r, extra in ROUTES.items()}
    cases["hier_shared"] = (HIER_SHARED, dict(explicit=False), "coarse")
    cases["hier_fine_microbatch"] = (HIER_FINE, dict(
        steps=2, explicit=False, microbatch=32), "fine")
    return cases


def spawn(fn, world: int, out: str, mesh_kw: dict, *args) -> None:
    """``fn(rank, mesh, out, *args)`` on ``world`` spawned ``gloo`` ranks
    over ``make_mesh(**mesh_kw)``."""
    mp.spawn(_rank_main, args=(world, out, mesh_kw, fn, args),
             nprocs=world, join=True)


def _rank_main(rank, world, out, mesh_kw, fn, args):
    from codenerf_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    pm.init_from_env("cpu", init_method=f"file://{out}/pg")
    try:
        fn(rank, pm.make_mesh(**mesh_kw), out, *args)
    finally:
        dist.destroy_process_group()


def _save(out, name, rank, res):
    np.save(os.path.join(out, f"{name}_{rank}.npy"), res, allow_pickle=True)


# ------------------------------------------------------------ the rank work
def _trainer_cfg() -> dict:
    """The autodiff route with the occupancy grid refreshed every 2 steps
    after a 2-step warm-up, a render log at step 4 and no periodic
    checkpoint (each run saves at its end)."""
    return cfg(use_fused_train=False, check_points=100,
               bound_sphere_radius=1.3,
               train_occupancy={"grid_size": 8, "warmup": 2,
                                "update_every": 2})


def _trainer(name, out, mesh):
    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.training.trainer import Trainer

    return Trainer(name, hparams_from_dict(_trainer_cfg()), batch_size=B,
                   dataset=_scene(), exps_root=out, check_iter=4,
                   device="cpu", mesh=mesh)


def _copy_step(out, src, dst, step=4):
    os.makedirs(os.path.join(out, dst, "ckpt"), exist_ok=True)
    name = f"step_{step:08d}.pt"
    shutil.copy(os.path.join(out, src, "ckpt", name),
                os.path.join(out, dst, "ckpt", name))


def _checkpoints(rank, mesh, out):
    """Checkpoints across one process and ``model = 2``: ``one`` (one
    process, rank 0) and ``tp`` (the mesh) train 4 steps; each resumes
    its own and the other's step-4 checkpoint (``c``: the mesh from
    ``one``'s, ``d``: one process from ``tp``'s) to step 6."""
    res = {}

    def run(name, m, key, resume=False):
        t = _trainer(name, out, m)
        if resume:
            res[f"{key}_resumed"] = (t.resume(), t.state.step)
            res[f"{key}4"] = whole(t.state)
        t.training(iters_crop=0, iters_all=6 if resume else 4, log_every=2)
        res[f"{key}{6 if resume else 4}"] = whole(t.state)

    if rank == 0:
        run("one", None, "one")
        run("one", None, "one", resume=True)
        _copy_step(out, "one", "c")
    dist.barrier()
    run("tp", mesh, "tp")
    run("tp", mesh, "tp", resume=True)
    run("c", mesh, "c", resume=True)
    dist.barrier()
    if rank == 0:
        _copy_step(out, "tp", "d")
        run("d", None, "d", resume=True)
    return res


def _refusals(mesh) -> dict:
    """The fused routes' refusals of a model axis, as messages."""
    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.training import train_step
    from codenerf_tpu_torch.training.trainer import Trainer

    res = {}
    for name, extra in (("single_pass", {}),
                        ("plane_op", {"fused_composite": False})):
        try:
            train_step.build_grad_fn(hparams_from_dict(cfg(**extra)), H, H,
                                     batch_size=B, mesh=mesh)
        except ValueError as e:
            res[name] = str(e)
    try:
        Trainer("fused", hparams_from_dict(cfg()), batch_size=B,
                dataset=_scene(), device="cpu", mesh=mesh)
    except ValueError as e:
        res["trainer"] = str(e)
    return res


def _tp2_worker(rank, mesh, out, trainables):
    from codenerf_tpu_torch.parallel import mesh as pm

    res = {"names": mesh.mesh_dim_names, "model": pm.model_size(mesh),
           "shard": pm.batch_shard(mesh)}
    for name, (extra, kw, which) in _cases().items():
        got = train_run(cfg(**extra), trainables[which], mesh, **kw)
        if rank == 0:
            got["want"] = train_run(cfg(**extra), trainables[which], **kw)
        res[name] = got
    res["refusals"] = _refusals(mesh)
    res["ckpt"] = _checkpoints(rank, mesh, out)
    _save(out, "tp2", rank, res)


def _tp8_worker(rank, mesh, out, trainables):
    res = {name: train_run(cfg(**extra), trainables["coarse"], mesh)
           for name, extra in ROUTES.items()}
    _save(out, "tp8", rank, res)


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def trainables():
    """JAX-initialized trainables (numpy) at latent 256, coarse and with a
    fine network."""
    import jax

    from codenerf_tpu.config import NetConfig as JNetConfig
    from codenerf_tpu.models.codenerf import init_codenerf
    from codenerf_tpu.models.codes import init_codes

    net = JNetConfig(**NET256)
    tr = {"params": init_codenerf(jax.random.PRNGKey(0), net),
          "shape_codes": init_codes(jax.random.PRNGKey(1), 3, 256),
          "texture_codes": init_codes(jax.random.PRNGKey(2), 3, 256)}
    fine = dict(tr, fine_params=init_codenerf(jax.random.PRNGKey(3), net))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"coarse": to_np(tr), "fine": to_np(fine)}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory, trainables):
    out = str(tmp_path_factory.mktemp("tp2"))
    spawn(_tp2_worker, 2, out, dict(data=1, model=2), trainables)
    return out


@pytest.fixture(scope="module")
def tp8(tmp_path_factory, trainables):
    out = str(tmp_path_factory.mktemp("tp8"))
    spawn(_tp8_worker, 8, out, dict(replica=2, data=2, model=2), trainables)
    return out


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- (a) the plan
def _port_name(keys) -> str:
    """A JAX trainables path (``params``/``fine_params``, layer, ``w``/
    ``b``; or a code table) as the port's trainable name."""
    if keys[0] in ("shape_codes", "texture_codes"):
        return keys[0]
    prefix = {"params": "model", "fine_params": "fine_model"}[keys[0]]
    return f"{prefix}.{keys[1]}.{'weight' if keys[2] == 'w' else 'bias'}"


def _jax_plan(jstate, jmesh) -> dict:
    """port leaf name -> (JAX shape, sharded over model) for every leaf of
    the JAX state; the optimizer's counters under ``count``."""
    import jax
    from jax.sharding import NamedSharding

    from codenerf_tpu.parallel.mesh import state_shardings

    shardings = state_shardings(jmesh, jstate)
    flat_sh = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    flat = jax.tree_util.tree_leaves(jstate)
    assert len(flat) == len(flat_sh)
    out = {}
    for (path, sh), leaf in zip(flat_sh, flat):
        keys = [getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))
                for k in path]
        if keys[0] == "trainables":
            name = _port_name(keys[1:])
        elif keys[0] == "opt_state":
            moment = next((k for k in keys if k in ("mu", "nu")), None)
            if moment is None:
                name = f"count/{len(out)}"
            else:
                rest = keys[keys.index(moment) + 1:]
                name = (f"{_port_name(rest)}/"
                        f"{'exp_avg' if moment == 'mu' else 'exp_avg_sq'}")
        else:
            name = {"step": "step", "rng": "generator"}[keys[0]]
        out[name] = (tuple(np.shape(leaf)), "model" in str(sh.spec))
    return out


FLAGSHIP = dict(shape_blocks=3, texture_blocks=1, W=256, num_xyz_freq=10,
                num_dir_freq=4)


@pytest.mark.parametrize("data,model,latent,fine", [
    (4, 2, 256, False), (4, 2, 32, False), (2, 4, 256, False),
    (2, 4, 32, False), (4, 2, 256, True)])
def test_shard_plan_matches_jax(data, model, latent, fine):
    """``state_shard_dims`` against the JAX package's ``state_shardings``
    on ``make_mesh(data, model)`` over the 8 virtual devices, at
    ``srncar.json`` widths: every weight, bias, code table and AdamW
    moment sharded there is sharded here on the dimension holding JAX's
    last axis, and nothing else is."""
    import jax

    from codenerf_tpu.config import hparams_from_dict as j_hparams
    from codenerf_tpu.parallel.mesh import make_mesh as j_make_mesh
    from codenerf_tpu.training.state import (
        create_train_state as j_create_train_state)
    from codenerf_tpu.training.train_step import (
        build_optimizer as j_build_optimizer)
    from codenerf_tpu_torch.config import hparams_from_dict
    from codenerf_tpu_torch.training import train_step
    from codenerf_tpu_torch.training.state import (create_train_state,
                                                   named_trainables,
                                                   state_shard_dims)

    d = cfg_dict(net_hyperparams=dict(FLAGSHIP, latent_dim=latent),
                 **(HIER_FINE if fine else ROUTES["autodiff"]))
    jhp, hp = j_hparams(d), hparams_from_dict(d)
    jstate = j_create_train_state(jax.random.PRNGKey(0), jhp, 3,
                                  j_build_optimizer(jhp))
    want = _jax_plan(jstate, j_make_mesh(data=data, model=model))
    state = create_train_state(hp, 3, "cpu")
    for p in train_step.trainable_params(state):   # materialize moments
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    got = state_shard_dims(state, model)
    leaves = named_trainables(state)
    for name, (shape, sharded) in want.items():
        if name.startswith("count/"):
            assert not sharded
            continue
        dim = got.pop(name)
        assert (dim is not None) == sharded, (name, dim, shape)
        if name in leaves:
            t = leaves[name]
            jax_last = 0 if name.endswith((".weight", ".bias")) else -1
            assert t.shape[jax_last] == shape[-1], name
            if sharded:
                assert dim % t.dim() == jax_last % t.dim(), name
    # What is left: AdamW's per-parameter step counts, never sharded.
    assert all(k.endswith("/step") and v is None for k, v in got.items())
    n_sharded = sum(s for _, s in want.values())
    if model == 4:
        assert n_sharded == 0            # 256 is not a multiple of 512
    else:
        # 11 layers of width 256 a network (weight and bias), and the
        # tables at latent 256; each with its two moments.
        per_net = 2 * (1 + 2 * 3 + 1 + 1 + 2 * 1)   # 11 layers
        nets = 2 if fine else 1
        assert n_sharded == 3 * (per_net * nets + 2 * (latent == 256))


# ------------------------------------------------ (b), (d): data=1, model=2
@pytest.mark.parametrize("case", list(_cases()))
def test_model_axis_repeats_one_process(tp2, trainables, case):
    """``(data=1, model=2)``: each rank's steps give one process's
    losses, first and last gathered gradients and gathered weights, bit
    for bit, and the weights moved."""
    from test_torch_sharding import flat_weights_start

    for rank in range(2):
        r = load(tp2, "tp2", rank)
        assert r["names"] == ("data", "model") and r["model"] == 2
        assert r["shard"] == (0, 1)
    got = [load(tp2, "tp2", r)[case] for r in range(2)]
    want = got[0]["want"]
    assert len(want["loss"]) == len(got[0]["loss"])
    for g in got:
        np.testing.assert_array_equal(g["loss"], want["loss"])
        for key in ("grads", "last_grads"):
            assert g[key].keys() == want[key].keys()
            for name, v in want[key].items():
                np.testing.assert_array_equal(g[key][name], v,
                                              err_msg=name)
        np.testing.assert_array_equal(g["weights"], want["weights"])
    extra, _, which = _cases()[case]
    start = flat_weights_start(trainables, which, net_hyperparams=NET256,
                               **extra)
    assert np.abs(got[0]["weights"] - start).max() > 1e-4


@pytest.mark.parametrize("case", list(_cases()))
def test_replicated_leaves_are_the_same_bits(tp2, case):
    """After the steps every replicated leaf — the layers narrower than
    256 (``sigma``, ``rgb_hidden``, ``rgb_out``), their AdamW moments,
    every AdamW step count and the generator — is the same bits on both
    ranks, and each rank holds its half of each sharded leaf: its block
    of the gathered weights, and moments of the block's shape."""
    got = [load(tp2, "tp2", r)[case] for r in range(2)]
    dims = got[0]["local"]["dims"]
    sharded = 0
    for name, v0 in got[0]["local"].items():
        if name == "dims":
            continue
        base, _, key = name.partition("/")
        dim = None if key == "step" else dims.get(base)
        if dim is None:
            np.testing.assert_array_equal(v0, got[1]["local"][name],
                                          err_msg=name)
            continue
        sharded += 1
        for r, g in enumerate(got):
            whole = g["whole"][base]
            k = whole.shape[dim] // 2
            block = np.take(whole, range(r * k, (r + 1) * k), axis=dim)
            assert g["local"][name].shape == block.shape, name
            if not key:
                np.testing.assert_array_equal(g["local"][name], block,
                                              err_msg=name)
    # 9 layers of width 256 at 2+1 blocks (weight and bias) a network and
    # both tables, each with its two moments.
    nets = 2 if "fine" in case else 1
    assert sharded == 3 * (18 * nets + 2)


# ------------------------------------------- (c): replica=2, data=2, model=2
@pytest.mark.parametrize("route", list(ROUTES))
def test_three_axis_mesh_matches_one_process(tp8, trainables, route):
    """8 ranks, ``(replica=2, data=2, model=2)``: the batch split 4 ways,
    the state 2 ways; 3 steps against one process at
    ``test_torch_sharding.py``'s bars, the same weights on every rank."""
    from test_torch_sharding import flat_weights_start

    got = [load(tp8, "tp8", r)[route] for r in range(8)]
    for g in got[1:]:
        np.testing.assert_array_equal(g["weights"], got[0]["weights"])
    want = train_run(cfg(**ROUTES[route]), trainables["coarse"])
    rounded = (set(want["grads"]) - {"shape_codes", "texture_codes"}
               if route == "autodiff" else ())
    start = flat_weights_start({"coarse": trainables["coarse"]},
                               net_hyperparams=NET256, **ROUTES[route])
    assert_matches(got[0], want, start, rounded,
                   f32=route == "autodiff_f32")


@pytest.mark.parametrize("route", list(ROUTES))
def test_three_axis_mesh_grads_match_jax(tp8, trainables, route):
    """The 8-rank run's first gathered gradients against ``jax.grad`` of
    the JAX package's plain loss on the whole batch at the same depths,
    at ``test_torch_sharding.py``'s bar."""
    import jax
    import jax.numpy as jnp

    from codenerf_tpu.config import hparams_from_dict as j_hparams
    from codenerf_tpu_torch.data.pipeline import RayBatchPipeline

    jhp = j_hparams(cfg(**ROUTES[route]))
    got = load(tp8, "tp8", 0)[route]
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


# ------------------------------------------------------ (e): checkpoints
def _ck_equal(a: dict, b: dict, path="") -> None:
    assert a.keys() == b.keys(), path
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _ck_equal(x, y, f"{path}/{k}")
        elif isinstance(x, torch.Tensor):
            assert x.shape == y.shape and torch.equal(x, y), f"{path}/{k}"
        elif isinstance(x, list):
            assert len(x) == len(y), f"{path}/{k}"
            for i, (u, v) in enumerate(zip(x, y)):
                _ck_equal({i: u}, {i: v}, f"{path}/{k}")
        else:
            assert x == y, f"{path}/{k}"


def test_checkpoints_cross_the_model_axis(tp2):
    """The ``Trainer`` on ``model = 2`` writes the one-process layout —
    its step-4 file equals one process's in every tensor, AdamW moments
    included — and the render log's PSNR; a one-process run resumes a
    ``model = 2`` checkpoint and a ``model = 2`` run a one-process one,
    each restoring the step and the state bit for bit and going on as the
    other would, with the occupancy grid refreshed under the axis."""
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    r = [load(tp2, "tp2", k)["ckpt"] for k in range(2)]
    one, ranks = r[0], r
    for res in ranks:
        for key in ("tp4", "tp6", "c4", "c6"):
            want = one[{"tp4": "one4", "tp6": "one6", "c4": "one4",
                        "c6": "one6"}[key]]
            for name, v in want.items():
                np.testing.assert_array_equal(res[key][name], v,
                                              err_msg=f"{key} {name}")
        assert res["tp_resumed"] == res["c_resumed"] == (True, 4)
    assert one["one_resumed"] == one["d_resumed"] == (True, 4)
    for name, v in one["tp4"].items():
        np.testing.assert_array_equal(one["d4"][name], v, err_msg=name)
        np.testing.assert_array_equal(one["d6"][name], one["tp6"][name],
                                      err_msg=name)
    assert np.abs(one["one6"]["model.enc_xyz.weight"]
                  - one["one4"]["model.enc_xyz.weight"]).max() > 0
    runs = {n: os.path.join(tp2, n) for n in ("one", "tp", "c", "d")}
    a = ckpt.read_checkpoint(os.path.join(runs["one"], "ckpt"), 4)
    b = ckpt.read_checkpoint(os.path.join(runs["tp"], "ckpt"), 4)
    assert b["shape_codes"].shape == (3, 256)
    assert b["model"]["enc_xyz.weight"].shape == (256, 39)
    assert b["optimizer"]["state"][0]["exp_avg"].shape == (256, 39)
    _ck_equal(a, b)
    for n in ("tp", "c", "d"):
        _ck_equal(ckpt.read_checkpoint(os.path.join(runs["one"], "ckpt"), 6),
                  ckpt.read_checkpoint(os.path.join(runs[n], "ckpt"), 6), n)

    def renders(run):
        with open(os.path.join(run, "metrics.jsonl")) as f:
            return [(row["step"], row["psnr/render"]) for row in map(
                json.loads, f) if "psnr/render" in row]

    assert renders(runs["tp"]) == renders(runs["one"])
    assert len(renders(runs["one"])) == 1

    from codenerf_tpu_torch.config import hparams_from_dict
    hp = hparams_from_dict(_trainer_cfg())
    got, want = (ckpt.load_run(runs[n], hp, "cpu") for n in ("tp", "one"))
    assert got[1] is None
    for x, y in zip(got[0].parameters(), want[0].parameters()):
        assert torch.equal(x, y)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


# ---------------------------------------------------------- (f): refusals
def test_fused_routes_refuse_the_model_axis(tp2):
    """``use_fused_train`` (the single pass and the plane op) with
    ``model = 2`` raises the JAX package's ``ValueError``, word for word,
    in ``build_grad_fn`` and in the ``Trainer`` before any step."""
    import optax

    from codenerf_tpu.config import hparams_from_dict as j_hparams
    from codenerf_tpu.parallel.mesh import make_mesh as j_make_mesh
    from codenerf_tpu.training import train_step as j_train_step

    with pytest.raises(ValueError) as e:
        j_train_step.build_train_step(j_hparams(cfg()), H, H,
                                      optax.adam(1e-3), batch_size=B,
                                      mesh=j_make_mesh(data=4, model=2))
    for rank in range(2):
        got = load(tp2, "tp2", rank)["refusals"]
        assert got == {"single_pass": str(e.value),
                       "plane_op": str(e.value), "trainer": str(e.value)}
