"""The training occupancy grid's schedule in the port's ``Trainer`` against
the JAX package's ``Trainer``, and both CLIs on the hierarchical,
sphere-bounded, occupancy-grid configuration on the CPU.

The schedule is compared exactly: which steps rebuild the grid from every
object, which refresh it from the next objects round-robin, and where the
cursor stands after each (the two trainers draw different random
numbers, so their densities are not compared here —
``test_torch_occupancy.py`` holds the density functions against JAX). The
port's grid is also held against its own density functions on the
trainer's state: the rebuild equals ``category_density_scan`` and a
refresh equals ``update_density_grid`` then ``grid_from_density``, bit
for bit (the same functions on the same tensors).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.data.synthetic import synthetic_scene, write_srn_layout
from codenerf_tpu.training.trainer import Trainer as JTrainer
from codenerf_tpu.utils import checkpoint as j_ckpt
from codenerf_tpu_torch import optimize as t_optimize
from codenerf_tpu_torch.config import hparams_from_dict, resolve_dtype
from codenerf_tpu_torch.core import occupancy as occ
from codenerf_tpu_torch.training.trainer import Trainer
from codenerf_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
OCC = {"grid_size": 8, "warmup": 2, "update_every": 2,
       "codes_per_update": 1, "sigma_threshold": 0.01, "dilate": 1,
       "decay": 0.9}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_objects=3, n_views=4, H=16, W=16, seed=0)


def _cfg(scene, **extra):
    """Hierarchical (8 + 8 samples), sphere-bounded, with a training grid;
    the autodiff route at W=32 for the schedule test."""
    return {"net_hyperparams": {"shape_blocks": 2, "texture_blocks": 1,
                                "W": 32, "num_xyz_freq": 4,
                                "num_dir_freq": 2, "latent_dim": 8},
            "N_samples": 8, "N_importance": 8,
            "near": float(scene["near"]), "far": float(scene["far"]),
            "bound_sphere_radius": 1.4, "train_occupancy": OCC,
            "use_fused_train": False, "check_points": 4, **extra}


def _record(tr, events):
    """Wrap a trainer's grid refreshes to log (kind, step, cursor)."""
    for kind in ("rebuild", "update"):
        fn = getattr(tr, f"_{kind}_occupancy")

        def wrapped(fn=fn, kind=kind):
            fn()
            events.append((kind, int(tr.state.step), tr._occ_cursor))

        setattr(tr, f"_{kind}_occupancy", wrapped)


def test_occupancy_schedule_matches_jax_trainer(scene, tmp_path):
    """Full grid in warm-up, rebuild at its end, round-robin refreshes
    every ``update_every``, and a rebuild on a resume past the warm-up —
    step for step and cursor for cursor as the JAX trainer does them."""
    jt = JTrainer("sched", j_hparams_from_dict(_cfg(scene)), batch_size=B,
                  dataset=scene, exps_root=str(tmp_path / "jax"),
                  check_iter=0)
    tt = Trainer("sched", hparams_from_dict(_cfg(scene)), batch_size=B,
                 dataset=scene, exps_root=str(tmp_path / "torch"),
                 check_iter=0, device="cpu")
    assert bool(tt.occupancy_grid.occ.all())        # warm-up: full grid
    grids = []
    step_fn = tt._train_step

    def capture(state, batch, tables, grid):
        grids.append((state.step, grid))
        return step_fn(state, batch, tables, grid)

    tt._train_step = capture
    jev, tev = [], []
    _record(jt, jev)
    _record(tt, tev)
    jt.training(iters_crop=2, iters_all=7, log_every=7)
    tt.training(iters_crop=2, iters_all=7, log_every=7)
    assert tev == jev == [("rebuild", 2, 0), ("update", 4, 1),
                          ("update", 6, 2)]
    assert [s for s, _ in grids] == list(range(7))
    assert all(bool(g.occ.all()) for s, g in grids if s < 2)
    assert grids[2][1] is not grids[1][1]

    # The trainer's grid is its density functions on its state.
    st, oc, cd = tt.state, tt.hp.train_occupancy, resolve_dtype("bfloat16")
    d_before, c = tt._density.clone(), tt._occ_cursor
    tt._update_occupancy()
    want = occ.update_density_grid(
        d_before, st.model, st.shape_codes.detach()[[c]],
        st.texture_codes.detach()[[c]], 1.4, decay=oc.decay,
        compute_dtype=cd)
    assert torch.equal(tt._density, want)
    assert torch.equal(tt.occupancy_grid.occ, occ.grid_from_density(
        want, 1.4, oc.sigma_threshold, oc.dilate, mask_radius=1.4).occ)
    tt._rebuild_occupancy()
    d_all, g_all = occ.category_density_scan(
        st.model, st.shape_codes.detach(), st.texture_codes.detach(),
        oc.grid_size, 1.4, 1, oc.sigma_threshold, oc.dilate, cd)
    assert torch.equal(tt._density, d_all)
    assert torch.equal(tt.occupancy_grid.occ, g_all.occ)

    # A resume past the warm-up rebuilds first (the density is not in
    # the checkpoint), then refreshes on schedule.
    jr = JTrainer("sched", j_hparams_from_dict(_cfg(scene)), batch_size=B,
                  dataset=scene, exps_root=str(tmp_path / "jax"),
                  check_iter=0)
    tr = Trainer("sched", hparams_from_dict(_cfg(scene)), batch_size=B,
                 dataset=scene, exps_root=str(tmp_path / "torch"),
                 check_iter=0, device="cpu")
    os.remove(ckpt.step_path(tr.ckpt_dir, 7))
    assert tr.resume() and tr.state.step == 4
    jr.state = j_ckpt.restore_checkpoint(jr.ckpt_dir, jr.state, 4)
    jev, tev = [], []
    _record(jr, jev)
    _record(tr, tev)
    jr.training(iters_crop=2, iters_all=7, log_every=7)
    tr.training(iters_crop=2, iters_all=7, log_every=7)
    assert tev == jev == [("rebuild", 4, 0), ("update", 6, 1)]
    with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if "occ/rebuild" in line]
    assert [(r["step"], r["occ/rebuild"]) for r in rows][-2:] == [
        (4, 1.0), (6, 0.0)]
    assert all(0.0 <= r["occ/occupied"] <= 1.0 for r in rows)


def test_coarse_fused_route_with_grid(scene, tmp_path):
    """The coarse fused route with sphere bounds and the training grid
    (``srncar_occ32.json``'s shape at tiny widths): the rebuild, a
    refresh, finite losses, and the grid reaching every step."""
    cfg = _cfg(scene, N_importance=0, use_fused_train=True,
               net_hyperparams={"shape_blocks": 2, "texture_blocks": 1,
                                "W": 256, "num_xyz_freq": 6,
                                "num_dir_freq": 2, "latent_dim": 8})
    tr = Trainer("coarse_occ", hparams_from_dict(cfg), batch_size=B,
                 dataset=scene, exps_root=str(tmp_path), check_iter=0,
                 device="cpu")
    ev = []
    _record(tr, ev)
    m = tr.training(iters_crop=1, iters_all=4, log_every=1)
    assert ev == [("rebuild", 2, 0), ("update", 4, 1)]
    assert np.isfinite([m["loss"], m["psnr"]]).all()


def test_occupancy_config_checks(scene, tmp_path):
    for extra, match in (({"shared_jitter": True}, "per-ray"),
                         ({"bound_sphere_radius": None}, "extent")):
        with pytest.raises(ValueError, match=match):
            Trainer("bad", hparams_from_dict(_cfg(scene, **extra)),
                    batch_size=B, dataset=scene, exps_root=str(tmp_path),
                    check_iter=0, device="cpu")


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory, scene):
    root = tmp_path_factory.mktemp("torch_hier_cli")
    data = str(root / "data")
    write_srn_layout(data, scene, cat="srn_cars", splits="cars_train")
    write_srn_layout(data, synthetic_scene(n_objects=1, n_views=3, H=16,
                                           W=16, seed=5),
                     cat="srn_cars", splits="cars_test")
    cfg = _cfg(scene, use_fused_train=True, check_points=2,
               net_hyperparams={"shape_blocks": 2, "texture_blocks": 1,
                                "W": 256, "num_xyz_freq": 6,
                                "num_dir_freq": 2, "latent_dim": 32},
               data={"cat": "srn_cars", "splits": "cars_train",
                     "data_dir": data})
    (root / "hier_occ.json").write_text(json.dumps(cfg))
    del cfg["train_occupancy"]
    (root / "hier.json").write_text(json.dumps(cfg))
    return root


def _cli(root, module, jsonfile, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", module, "--jsonfile", str(root / jsonfile),
         "--exps_root", str(root / "exps"), "--device", "cpu", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out


def test_hier_occ_train_then_optimize_cli(cli_root):
    """``python -m codenerf_tpu_torch.train`` on the fused hierarchical
    route with the training grid (its refreshes in ``metrics.jsonl``),
    resumed past the warm-up (a rebuild), then ``python -m
    codenerf_tpu_torch.optimize --opt_occ true --opt_samples 4``."""
    common = ("--iters_crop", "2", "--batchsize", str(B), "--log_every", "1",
              "--check_iter", "0")
    _cli(cli_root, "codenerf_tpu_torch.train", "hier_occ.json",
         "--save_dir", "run", "--iters_all", "4", *common)
    run = cli_root / "exps" / "run"
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss/train"] for r in rows if "loss/train" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert [(r["step"], r["occ/rebuild"]) for r in rows
            if "occ/rebuild" in r] == [(2, 1.0), (4, 0.0)]
    out = _cli(cli_root, "codenerf_tpu_torch.train", "hier_occ.json",
               "--save_dir", "run", "--iters_all", "6", *common)
    assert "resumed from step 4" in out.stdout
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["step"], r["occ/rebuild"]) for r in rows
            if "occ/rebuild" in r][2:] == [(4, 1.0), (6, 0.0)]
    assert ckpt.latest_step(str(run / "ckpt")) == 6
    _cli(cli_root, "codenerf_tpu_torch.optimize", "hier_occ.json",
         "--saved_dir", "run", "--num_opts", "2", "--tgt_instances", "0",
         "--opt_occ", "true", "--opt_samples", "4")
    with open(run / "test" / "results.json") as f:
        res = json.load(f)
    assert len(res["per_object"]) == 1
    assert np.isfinite([res["mean_psnr"], res["mean_ssim"]]).all()


def test_opt_occ_needs_a_training_grid(cli_root):
    with pytest.raises(SystemExit, match="train_occupancy"):
        t_optimize.main(["--device", "cpu", "--jsonfile",
                         str(cli_root / "hier.json"), "--exps_root",
                         str(cli_root / "exps"), "--opt_occ", "true"])
