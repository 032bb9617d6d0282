"""The separate fine network in the port (``hierarchical_share_weights:
false``): its state against the JAX package's trainables, its
checkpoints, an exact resume, and the train, optimize and pose CLIs as
subprocesses on a tiny separate-fine configuration on the CPU (the
plane-op routes; their numbers against JAX: tests/test_torch_plane_routes
.py).

Tolerances: the weights carried over from JAX and through a checkpoint
are exact (copies); a resumed run repeats the uninterrupted run's losses
and weights bit for bit (the same CPU arithmetic on the same batches and
draws).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.data.synthetic import synthetic_scene, write_srn_layout
from codenerf_tpu.training import state as j_state
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.training import state as t_state
from codenerf_tpu_torch.training.trainer import Trainer
from codenerf_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 256, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": 32}


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
    return {"net_hyperparams": NET, "N_samples": 8, "N_importance": 8,
            "hierarchical_share_weights": False,
            "near": float(scene["near"]), "far": float(scene["far"]),
            "bound_sphere_radius": 1.4, "use_fused_train": True, **extra}


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def test_state_carries_the_fine_network(scene):
    """``trainables_from_jax`` takes ``fine_params``; the fine network
    joins AdamW's model group; a fresh state draws it right after the
    coarse network, before the codes (JAX ``make_trainables``' order)."""
    jhp, hp = j_hparams_from_dict(_cfg(scene)), hparams_from_dict(_cfg(scene))
    jtr = jax.tree_util.tree_map(np.asarray, j_state.make_trainables(
        jax.random.PRNGKey(0), jhp, 3))
    assert "fine_params" in jtr
    st = t_state.trainables_from_jax(jtr, hp)
    for model, key in ((st.model, "params"), (st.fine_model, "fine_params")):
        want = params_from_jax(jtr[key])
        got = model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), key
    group = {id(p) for p in st.optimizer.param_groups[0]["params"]}
    assert {id(p) for p in st.fine_model.parameters()} <= group
    assert {id(p) for p in st.model.parameters()} <= group
    assert len(group) == 2 * len(list(st.model.parameters()))

    gen = torch.Generator().manual_seed(7)
    model, sc, tc, fine = t_state.make_trainables(hp, 3, gen)
    gen = torch.Generator().manual_seed(7)
    assert _same_weights(model, CodeNeRF(hp.net, generator=gen))
    assert _same_weights(fine, CodeNeRF(hp.net, generator=gen))
    assert not _same_weights(model, fine)
    shared = hparams_from_dict(_cfg(scene, hierarchical_share_weights=True))
    gen = torch.Generator().manual_seed(7)
    assert t_state.make_trainables(shared, 3, gen)[3] is None
    assert not t_state.trainables_from_jax(
        {k: v for k, v in jtr.items() if k != "fine_params"}, shared
    ).fine_model


def test_checkpoint_round_trip_and_exact_resume(scene, tmp_path):
    """4 steps with checkpoints at 2 and 4, against a second trainer that
    resumes from the step-2 checkpoint: the same losses and the same
    weights of both networks, bit for bit. A checkpoint restores into a
    state whose fine network it matches, and refuses one it does not."""
    hp = hparams_from_dict(_cfg(scene, check_points=2))

    def trainer(name):
        return Trainer(name, hp, batch_size=B, dataset=scene,
                       exps_root=str(tmp_path), check_iter=0, device="cpu")

    tr = trainer("run")
    tr.training(iters_crop=1, iters_all=4, log_every=1)
    os.makedirs(tmp_path / "resumed" / "ckpt")
    shutil.copy(ckpt.step_path(tr.ckpt_dir, 2),
                ckpt.step_path(str(tmp_path / "resumed" / "ckpt"), 2))
    tr2 = trainer("resumed")
    assert tr2.resume() and tr2.state.step == 2
    tr2.training(iters_crop=1, iters_all=4, log_every=1)

    def losses(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return {r["step"]: r["loss/train"] for r in map(json.loads, f)
                    if "loss/train" in r}

    l1, l2 = losses("run"), losses("resumed")
    assert l2 == {s: l1[s] for s in (3, 4)}
    assert _same_weights(tr.state.model, tr2.state.model)
    assert _same_weights(tr.state.fine_model, tr2.state.fine_model)
    assert torch.equal(tr.state.shape_codes, tr2.state.shape_codes)
    assert not _same_weights(tr.state.model, tr.state.fine_model)
    assert np.isfinite(tr.render_view(0, 1)).all()

    fresh = t_state.create_train_state(hp, 3, device="cpu")
    ckpt.restore_checkpoint(tr.ckpt_dir, fresh)
    assert _same_weights(fresh.fine_model, tr.state.fine_model)
    shared = t_state.create_train_state(
        hparams_from_dict(_cfg(scene, hierarchical_share_weights=True)), 3,
        device="cpu")
    with pytest.raises(ValueError, match="fine network"):
        ckpt.restore_checkpoint(tr.ckpt_dir, shared)


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory, scene):
    """A tiny SRN-layout set: ``cars_train`` 16×16, ``cars_test`` 13×13
    (169 rays: with ``--batchsize 64`` the optimize CLI pads them to 3
    chunks of 64)."""
    root = tmp_path_factory.mktemp("torch_fine_cli")
    data = str(root / "data")
    write_srn_layout(data, scene, cat="srn_cars", splits="cars_train")
    write_srn_layout(data, synthetic_scene(n_objects=1, n_views=3, H=13,
                                           W=13, seed=5),
                     cat="srn_cars", splits="cars_test")
    cfg = _cfg(scene, check_points=2,
               data={"cat": "srn_cars", "splits": "cars_train",
                     "data_dir": data})
    (root / "fine.json").write_text(json.dumps(cfg))
    return root


def _cli(root, module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", module, "--jsonfile", str(root / "fine.json"),
         "--exps_root", str(root / "exps"), "--device", "cpu", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out


def test_train_optimize_and_pose_clis(cli_root):
    """``python -m codenerf_tpu_torch.train`` on the separate-fine plane-op
    route (checkpoints hold both networks), then ``.optimize`` over the
    padded 13×13 views and ``.pose_opt`` on that run, each reading the
    fine network from ``ckpt/``."""
    _cli(cli_root, "codenerf_tpu_torch.train", "--save_dir", "run",
         "--iters_crop", "1", "--iters_all", "2", "--batchsize", str(B),
         "--log_every", "1", "--check_iter", "0")
    run = cli_root / "exps" / "run"
    with open(run / "metrics.jsonl") as f:
        losses = [r["loss/train"] for r in map(json.loads, f)
                  if "loss/train" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    saved = torch.load(ckpt.step_path(str(run / "ckpt"), 2),
                       map_location="cpu", weights_only=True)
    assert saved["fine_model"].keys() == saved["model"].keys()
    _cli(cli_root, "codenerf_tpu_torch.optimize", "--saved_dir", "run",
         "--num_opts", "2", "--tgt_instances", "0", "--batchsize", "64")
    with open(run / "test" / "results.json") as f:
        res = json.load(f)
    assert len(res["per_object"]) == 1
    assert np.isfinite([res["mean_psnr"], res["mean_ssim"]]).all()
    _cli(cli_root, "codenerf_tpu_torch.pose_opt", "--saved_dir", "run",
         "--num_opts", "2", "--rays_per_step", "64", "--save_img", "false")
    with open(run / "pose_opt" / "results.json") as f:
        rows = json.load(f)["per_object"]
    assert len(rows) == 1
    assert np.isfinite([v for k, v in rows[0].items() if k != "id"]).all()
