"""The code tables' gather and its fixed-order gradient
(``codenerf_tpu_torch/ops/code_rows.py``) against the JAX package's code
gather on the CPU, where ``code_row_sums`` runs its plain version, and
the training step going through it on every route.

Tolerances, each with its reason:

- the gradient of the gather (``code_row_sums_plain``, and the backward
  of ``gather_code_rows``) against ``jax.vjp(lambda t: t[obj], table)``
  — XLA's scatter-add, the JAX step's transpose — on normal draws: both
  sum the same f32 terms in other orders, so each element is held to
  rtol 1e-6 of the sum of its terms' magnitudes (the scale of a
  summation-order difference; at 4,096 terms it measures ~1e-8). On
  draws that are multiples of 1/4 below 8 every partial sum is exact, and
  there the two are the same bits;
- the forward against ``index_select``: the same bits;
- two trainings from one seed: the same bits.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.data.synthetic import synthetic_scene
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.core import occupancy
from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
from codenerf_tpu_torch.ops import code_rows
from codenerf_tpu_torch.training import train_step
from codenerf_tpu_torch.training.state import create_train_state
from codenerf_tpu_torch.training.trainer import Trainer

T = code_rows.TILE

# name -> (rays, objects, how the rays pick their objects)
CASES = {
    "one_object": (100, 1, "uniform"),
    "four_objects": (4 * T, 4, "uniform"),
    "sixteen_ragged": (16 * T + 37, 16, "uniform"),
    "cars_train_objects": (3 * 2458 + 5, 2458, "uniform"),
    "empty_objects": (3 * T + 11, 9, "odd_only"),
    "all_on_one_of_many": (2 * T + 1, 7, "one"),
    "long_segment_and_singletons": (6 * T + 3, 40, "skewed"),
    "one_ray": (1, 3, "uniform"),
}


def _obj(rng, R, n, how):
    if how == "uniform":
        return rng.integers(0, n, R)
    if how == "odd_only":            # every even object has no rays
        return rng.choice(np.arange(1, n, 2), R)
    if how == "one":
        return np.full(R, n // 2)
    # One object takes most rays, the rest one or two each, shuffled.
    obj = np.concatenate([np.full(R - 2 * (n - 1), 3),
                          np.repeat(np.arange(n - 1) + (np.arange(n - 1) >= 3),
                                    2)])
    return rng.permutation(obj)


def _inputs(case, D=6, dyadic=False, seed=0):
    R, n, how = CASES[case]
    rng = np.random.default_rng(seed)
    obj = _obj(rng, R, n, how).astype(np.int64)
    if dyadic:
        g = rng.integers(-32, 32, (R, D)).astype(np.float32) / 4
    else:
        g = rng.standard_normal((R, D)).astype(np.float32)
    table = rng.standard_normal((n, D)).astype(np.float32)
    return obj, g, table


def _jax_grad(table, obj, g):
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(obj)], jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _assert_order_close(got, want, obj, g):
    scale = np.zeros(want.shape, np.float64)
    np.add.at(scale, obj, np.abs(g).astype(np.float64))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-6 * scale).all(), float((err / np.maximum(
        scale, 1e-30)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_sums_match_jax_vjp(case):
    """``code_row_sums_plain`` against the JAX gather's VJP: within rtol
    1e-6 of each element's term scale on normal draws, the same bits on
    exact (dyadic) draws; every empty object's row 0."""
    for dyadic in (False, True):
        obj, g, table = _inputs(case, dyadic=dyadic)
        n = table.shape[0]
        order = code_rows.RowOrder.of(torch.from_numpy(obj), n)
        got = code_rows.code_row_sums_plain(torch.from_numpy(g), order,
                                            n).numpy()
        want = _jax_grad(table, obj, g)
        assert got.shape == want.shape == table.shape
        if dyadic:
            np.testing.assert_array_equal(got, want)
        else:
            _assert_order_close(got, want, obj, g)
        empty = np.setdiff1d(np.arange(n), obj)
        assert (got[empty] == 0).all()


@pytest.mark.parametrize("case", ["sixteen_ragged", "cars_train_objects",
                                  "empty_objects", "one_object"])
def test_gather_forward_and_backward(case):
    """``gather_code_rows``: the forward the same bits as
    ``index_select``, the backward (through a downstream use of the
    gathered rows) ``code_row_sums_plain`` of the rows' cotangents and,
    to rtol 1e-6 of the term scale, the JAX gather's VJP of them."""
    obj, g, table = _inputs(case, D=5, seed=3)
    n = table.shape[0]
    t = torch.from_numpy(table).requires_grad_()
    ob = torch.from_numpy(obj)
    order = code_rows.RowOrder.of(ob, n)
    rows = code_rows.gather_code_rows(t, ob, order)
    assert torch.equal(rows, t.detach().index_select(0, ob))
    (rows * torch.from_numpy(g)).sum().backward()
    assert torch.equal(t.grad, code_rows.code_row_sums_plain(
        torch.from_numpy(g), order, n))
    _assert_order_close(t.grad.numpy(), _jax_grad(table, obj, g), obj, g)


def test_row_order_is_stable_and_segments():
    """An object's rays keep their ray order; each object's segment
    starts at ``offsets[o]``, empty ones included."""
    obj = torch.tensor([2, 0, 2, 2, 0, 4, 2])
    o = code_rows.RowOrder.of(obj, 6)
    assert o.perm.tolist() == [1, 4, 0, 2, 3, 6, 5]
    assert o.sorted_obj.tolist() == [0, 0, 2, 2, 2, 2, 4]
    assert o.offsets.tolist() == [0, 2, 2, 6, 6, 7, 7]


def test_wrapper_refuses_what_it_cannot_launch():
    """A tensor off the CPU that is not on a CUDA card raises (no plain
    fallback), as does an order of other sizes."""
    g = torch.zeros(4, 3)
    order = code_rows.RowOrder.of(torch.tensor([0, 1, 1, 0]), 2)
    with pytest.raises(ValueError, match="order of"):
        code_rows.code_row_sums(g, order, 3)
    meta = code_rows.RowOrder(*(x.to("meta") for x in (
        order.perm, order.sorted_obj, order.offsets)))
    with pytest.raises(ValueError, match="CUDA"):
        code_rows.code_row_sums(g.to("meta"), meta, 2)


# ------------------------------------------------------- the training routes
NET = dict(shape_blocks=2, texture_blocks=1, W=256, num_xyz_freq=6,
           num_dir_freq=2, latent_dim=32)
R, S = 32, 16
OCC = {"grid_size": 8, "warmup": 2, "update_every": 2}
ROUTES = {
    "single_pass": {"use_fused_train": True},
    "hier_dual_occupancy": {"use_fused_train": True, "N_importance": 8,
                            "bound_sphere_radius": 1.3,
                            "train_occupancy": OCC},
    "separate_fine": {"use_fused_train": True, "N_importance": 8,
                      "hierarchical_share_weights": False},
    "plane_op": {"use_fused_train": True, "fused_composite": False},
    "autodiff": {"use_fused_train": False},
}


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_objects=3, n_views=4, H=16, W=16, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hp(scene, **extra):
    return hparams_from_dict({
        "net_hyperparams": NET, "N_samples": S, "near": float(scene["near"]),
        "far": float(scene["far"]), **extra})


@pytest.mark.parametrize("micro", [0, R], ids=["whole", "microbatch"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_gathers_through_code_rows(scene, route, micro,
                                               monkeypatch):
    """The training step's loss gathers both tables through
    ``gather_code_rows`` (its counter: two calls a (micro)batch) and
    their gradients come from ``code_row_sums`` (here its plain version:
    two calls a (micro)batch), whatever the route."""
    calls = {"sums": 0}
    plain = code_rows.code_row_sums_plain

    def counted(*args):
        calls["sums"] += 1
        return plain(*args)

    monkeypatch.setattr(code_rows, "code_row_sums_plain", counted)
    hp = _hp(scene, **ROUTES[route])
    state = create_train_state(hp, 3, "cpu")
    H, W = scene["images"].shape[2:4]
    b = RayBatchPipeline(scene["images"], scene["poses"], scene["focals"],
                         seed=1).sample(2 * R)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    grad_fn = train_step.build_grad_fn(hp, H, W, microbatch_rays=micro,
                                       batch_size=2 * R)
    extra = {}
    if hp.train_occupancy is not None:
        extra["occ_grid"] = occupancy.full_grid(8, 1.3, "cpu")
    before = code_rows.gather_code_rows.calls
    m = grad_fn(state, tb, **extra)
    k = 2 if micro else 1
    assert code_rows.gather_code_rows.calls - before == 2 * k
    assert calls["sums"] == 2 * k
    assert np.isfinite(float(m["loss"]))
    for t in (state.shape_codes, state.texture_codes):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)


def test_two_trainings_of_one_seed_are_the_same_bits(scene, tmp_path):
    """Two fresh trainers from one seed, 6 steps across the crop→full
    switch on the single-pass route: every parameter, both tables, every
    AdamW moment and every logged loss the same bits."""
    hp = _hp(scene, use_fused_train=True, check_points=100)
    runs = []
    for name in ("a", "b"):
        tr = Trainer(name, hp, batch_size=R, dataset=scene,
                     exps_root=str(tmp_path), check_iter=0, device="cpu")
        tr.training(iters_crop=3, iters_all=6, log_every=1)
        with open(tmp_path / name / "metrics.jsonl") as f:
            losses = [(r["step"], r["loss/train"], r["psnr/train"],
                       r["reg/train"]) for r in map(json.loads, f)
                      if "loss/train" in r]
        opt = tr.state.optimizer.state_dict()["state"]
        runs.append((train_step.trainable_params(tr.state), opt, losses))
    (pa, oa, la), (pb, ob, lb) = runs
    assert len(la) == 6 and la == lb
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[i][k], ob[i][k])
