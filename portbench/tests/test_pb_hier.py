"""The hierarchical served cell (``car_nerf_hier.serve``, kind
``serve_hier``) at the CPU tests' size: the trunk's bounds in its two
forward-only modes, the cell's readers (None where a run gave them
nothing, as a program without the kernels' route gives; their value on
hand-made readings), a sound run, the planted ``uniform_fine`` fault (the
fine depths drawn as if the coarse weights were uniform), which
``correct`` must refuse, and the control: the fp8 reference and the
fault each fail a limit of the cell where the program passes."""

import importlib
import tempfile
import time

import pytest
import torch

from portbench.harness import arith, arith_hier, manifest
from portbench.harness.cell import Context
from portbench.tests.small import small

CELL = "car_nerf_hier.serve"
CARS = {"W": 256, "shape_blocks": 3, "texture_blocks": 1, "num_xyz_freq": 10,
        "num_dir_freq": 4, "latent_dim": 256}
HP = {"N_samples": 64, "N_importance": 128}
METRICS = [m["name"] for m in manifest.load()["per_layer"]
           if CELL in m.get("workloads", [])]


def test_trunk_bounds():
    """Both modes are bound by their operations at a view's launch:
    557,056 FLOP a point for the sigma trunk, 884,736 for the whole."""
    P = 16384 * 64
    sigma = arith_hier.trunk_fwd_bound(CARS, 1, P, 64, True)
    assert sigma == pytest.approx(557056 * P / arith.PEAK_BF16_FLOPS * 1e3)
    planes = arith_hier.trunk_fwd_bound(CARS, 2, 2 * 3 * P, 192, False)
    assert planes == pytest.approx(2 * 884736 * 3 * P
                                   / arith.PEAK_BF16_FLOPS * 1e3)
    assert arith_hier.trunk_fwd_bound(CARS, 0, 0, 64, True) == 0.0


def _trace(kernels: dict, busy_s: float = 0.02) -> dict:
    return {"busy_s": busy_s, "window_s": 0.03,
            "kernel_s": {k: v[0] for k, v in kernels.items()},
            "kernel_n": {k: v[1] for k, v in kernels.items()}}


PARENT = {"kind": "serve_hier", "net": CARS, "hparams": HP,
          "render_ms": 60.0, "samples_per_render": None, "launches":
          {"sigma": 0, "planes": 0}, "points": {"sigma": 0, "planes": 0},
          "held_s": 1.2,
          "trace": _trace({"void at::native::elementwise_kernel": (1.0, 99)},
                          1.0)}


@pytest.mark.parametrize("name", METRICS)
def test_readers_none_on_nothing(name):
    """Nothing from another kind's readings or none; from a program that
    renders the cell through its plain module, only what it has: the
    lock's p50 and, traced, the device's idle and plain shares."""
    read = manifest.load_reader(name)
    for r in ({}, {"kind": "serve", "render_ms": 10.0}):
        assert read(r) is None
    untraced = dict(PARENT, trace=None)
    if name == "serving.render_ms.hier":
        assert read(untraced) == read(PARENT) == 60.0
    elif name.startswith(("step.mfu", "kernels.")):
        assert read(untraced) is None and read(PARENT) is None
    else:
        assert read(untraced) is None and read(PARENT) is not None


def test_readers_values():
    P = 16384
    r = {"kind": "serve_hier", "net": CARS, "hparams": HP, "render_ms": 20.0,
         "samples_per_render": {"coarse_sigma": P * 64, "planes": P * 192},
         "launches": {"sigma": 2, "planes": 2},
         "points": {"sigma": 2 * P * 64, "planes": 2 * P * 192},
         "held_s": 0.05,
         "trace": _trace({"(anonymous)::trunk_fwd_kernel<A>": (0.02, 2),
                          "(anonymous)::trunk_fwd_kernel<B>": (0.008, 2),
                          "(anonymous)::plane_head_kernel": (0.002, 2),
                          "(anonymous)::composite_kernel": (0.001, 2),
                          "at::native::sort": (0.002, 2),
                          "Memcpy DtoH": (0.001, 2)}, 0.034)}
    read = {n: manifest.load_reader(n) for n in METRICS}
    flops = P * (64 * 557056 + 192 * 884736)
    assert read["serving.render_ms.hier"](r) == 20.0
    assert read["step.mfu.render_hier"](r) == pytest.approx(
        100 * flops / 0.02 / arith.PEAK_BF16_FLOPS)
    assert read["device.idle_share.render_hier"](r) == pytest.approx(32.0)
    bound = 2 * (arith_hier.trunk_fwd_bound(CARS, 1, P * 64, 64, True)
                 + arith_hier.trunk_fwd_bound(CARS, 1, P * 192, 192, False))
    assert read["kernels.trunk_fwd_roofline.render_hier"](r) == \
        pytest.approx(100 * bound * 1e-3 / 0.028)
    assert read["render.plain_ops_share.render_hier"](r) == pytest.approx(
        100 * 0.003 / 0.034)
    uncounted = dict(r, launches={"sigma": 2, "planes": 1})
    assert read["kernels.trunk_fwd_roofline.render_hier"](uncounted) is None


def _outcome(seed=2 ** 31 + 7):
    """A run of the cell at the small size: four 16 x 16 views of the
    served object (the program reads about 0.2-0.35 levels, the fault
    1.7-2.3 and the fp8 reference 2.4-4.9 over seeds 31337, 2**31 + 7
    and 3000000021)."""
    config, tf = small(CELL)
    kind = importlib.import_module(f"portbench.kinds.{tf['kind']}")
    with tempfile.TemporaryDirectory() as work:
        return kind.run(Context(CELL, config, tf, seed, 0.5, False,
                                torch.device("cpu"), time.perf_counter(),
                                work)), tf


def _correct(out) -> bool:
    return all(c.ok for c in out.checks) and out.failed == 0


def test_sound():
    out, tf = _outcome()
    assert _correct(out), {c.name: c.value for c in out.checks}
    assert out.readings["kind"] == "serve_hier"
    assert out.readings["samples_per_render"] == {"coarse_sigma": 0,
                                                  "planes": 0}  # CPU: plain


def _uniform_fine(monkeypatch):
    from codenerf_tpu_torch import renderer

    fine_zvals = renderer.fine_zvals

    def uniform(rcfg, z, weights, generator, u=None):
        return fine_zvals(rcfg, z, torch.ones_like(weights), generator, u)
    monkeypatch.setattr(renderer, "fine_zvals", uniform)


def test_uniform_fine_fault(monkeypatch):
    _uniform_fine(monkeypatch)
    out, _ = _outcome()
    assert not _correct(out), {c.name: c.value for c in out.checks}


def test_control_fails_program_passes():
    config, tf = small(CELL)
    kind = importlib.import_module(f"portbench.kinds.{tf['kind']}")
    with tempfile.TemporaryDirectory() as work:
        ctx = Context(CELL, config, tf, 31337, 0.0, False,
                      torch.device("cpu"), time.perf_counter(), work)
        out = kind.control(ctx, ["program", "fp8", "uniform_fine"])
    limits = tf["correct"]
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    for v in ("fp8", "uniform_fine"):
        assert any(out[v][k] > lim for k, lim in limits.items()), (v, out)
