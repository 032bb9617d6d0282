"""The port's training loop and CLIs on the CPU: ``Trainer`` (crop→full
schedule, checkpoints, exact resume, crash-safe save, profile, render
logging), ``python -m codenerf_tpu_torch.train`` and the optimize CLI
reading what the trainer wrote.

Sizes are small (W=256 because the single-pass kernel needs it; 2+1
blocks, latent 32, 24 samples, 64 rays per step on a 16×16 synthetic
scene), so every step runs the fused route through the kernel's plain
version. Resume is compared bit for bit: the same stream of batches, the
same generator state and the same CPU arithmetic give the same bits.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from codenerf_tpu.data.synthetic import synthetic_scene, write_srn_layout
from codenerf_tpu_torch import train as t_train
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.training import train_step
from codenerf_tpu_torch.training.trainer import Trainer
from codenerf_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 64
NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 256, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": 32}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These tests are matmul-bound at W=256. Beside the other test
    workers, PyTorch's default of one thread per core oversubscribes the
    machine many times over (a 3 s test took two minutes), so this module
    and the CLIs it starts use two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_objects=3, n_views=4, H=16, W=16, seed=0)


def _cfg(scene, fused=True, **extra):
    return {"net_hyperparams": NET, "N_samples": 24,
            "near": float(scene["near"]), "far": float(scene["far"]),
            "lr_schedule": [{"type": "step", "lr": 5e-4, "interval": 100000},
                            {"type": "step", "lr": 5e-3, "interval": 100000}],
            "use_fused_train": fused, **extra}


def _trainer(scene, tmp_path, name, fused=True, **extra):
    hp = hparams_from_dict(_cfg(scene, fused, **extra))
    return Trainer(name, hp, batch_size=B, dataset=scene,
                   exps_root=str(tmp_path), check_iter=0, device="cpu")


def _fixed_batch_loss(tr, batch, z):
    """The loss of one fixed batch and depths under the trainer's state
    (the gradients this leaves behind are cleared)."""
    grad_fn = train_step.build_grad_fn(tr.hp, tr.H, tr.W, batch_size=B)
    loss = float(grad_fn(tr.state, batch, z=z)["loss"])
    tr.state.optimizer.zero_grad(set_to_none=True)
    return loss


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "autodiff"])
def test_short_run_lowers_the_loss_on_a_fixed_batch(scene, tmp_path, fused):
    """(f) 30 steps of the two-stage schedule lower the loss of a batch
    held fixed before and after; every logged step is finite."""
    tr = _trainer(scene, tmp_path, "lower", fused)
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(v) for k, v in
             tr.pipeline.sample(B, rng=rng).items()}
    z = torch.from_numpy(np.sort(rng.uniform(
        float(scene["near"]), float(scene["far"]), (B, 24)),
        axis=-1).astype(np.float32))
    before = _fixed_batch_loss(tr, batch, z)
    m = tr.training(iters_crop=10, iters_all=30, log_every=10)
    after = _fixed_batch_loss(tr, batch, z)
    assert tr.state.step == 30
    assert after < 0.8 * before, (before, after)
    assert np.isfinite([m["loss"], m["psnr"], m["rays_per_sec"]]).all()
    with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [10, 20, 30]
    assert all(np.isfinite(r["loss/train"]) for r in rows)


def _state_arrays(state):
    out = {k: v.detach().clone() for k, v in
           state.model.state_dict().items()}
    out["shape_codes"] = state.shape_codes.detach().clone()
    out["texture_codes"] = state.texture_codes.detach().clone()
    return out


@pytest.mark.parametrize("resume_at", [3, 6], ids=["in_crop", "in_full"])
def test_resume_matches_an_uninterrupted_run_exactly(scene, tmp_path,
                                                     resume_at):
    """(f) A run resumed from a mid-run checkpoint — inside the crop phase
    or after the switch to whole images — ends with the uninterrupted
    run's state and losses, bit for bit."""
    full = _trainer(scene, tmp_path, "full", check_points=3)
    full.training(iters_crop=4, iters_all=8, log_every=1)
    assert sorted(os.listdir(full.ckpt_dir)) == [
        "step_00000003.pt", "step_00000006.pt", "step_00000008.pt"]

    resumed = _trainer(scene, tmp_path, "resumed", check_points=3)
    os.makedirs(resumed.ckpt_dir)
    shutil.copy(ckpt.step_path(full.ckpt_dir, resume_at), resumed.ckpt_dir)
    assert resumed.resume() and resumed.state.step == resume_at
    resumed.training(iters_crop=4, iters_all=8, log_every=1)

    want, got = _state_arrays(full.state), _state_arrays(resumed.state)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(full.state.generator.get_state(),
                       resumed.state.generator.get_state())
    for a, b in zip(full.state.optimizer.state_dict()["state"].values(),
                    resumed.state.optimizer.state_dict()["state"].values()):
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))

    def losses(tr):
        with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
            return {r["step"]: r["loss/train"] for r in map(json.loads, f)}

    lf, lr = losses(full), losses(resumed)
    assert sorted(lr) == list(range(resume_at + 1, 9))
    assert all(lr[s] == lf[s] for s in lr)


def test_crash_leaves_a_resumable_checkpoint(scene, tmp_path):
    """A step that fails mid-run leaves a checkpoint at the last completed
    step, and the original error propagates."""
    tr = _trainer(scene, tmp_path, "crash")
    step_fn = tr._train_step

    def failing(state, batch, tables):
        if state.step == 2:
            raise OSError("device lost")
        return step_fn(state, batch, tables)

    tr._train_step = failing
    with pytest.raises(OSError, match="device lost"):
        tr.training(iters_crop=0, iters_all=5, log_every=1)
    assert ckpt.latest_step(tr.ckpt_dir) == 2
    again = _trainer(scene, tmp_path, "crash")
    assert again.resume() and again.state.step == 2


def test_run_dir_layout_and_hpam_round_trip(scene, tmp_path):
    """``exps/<dir>/{hpam.json, metrics.jsonl, ckpt/}``; hpam.json reads
    back to the same hyperparameters."""
    tr = _trainer(scene, tmp_path, "layout", check_points=2,
                  reference_quirks={"optimizer_reset_every": 4})
    tr.training(iters_crop=1, iters_all=2, log_every=1)
    assert sorted(os.listdir(tr.save_dir)) == ["ckpt", "hpam.json",
                                               "metrics.jsonl"]
    with open(os.path.join(tr.save_dir, "hpam.json")) as f:
        back = hparams_from_dict(json.load(f))
    assert dataclasses.replace(back, raw=None) == dataclasses.replace(
        tr.hp, raw=None)


def test_render_logging_and_profile(scene, tmp_path):
    """``check_iter`` renders a view through the port's ``render_image``
    and logs its PSNR and a side-by-side PNG; ``profile_steps`` writes a
    trace and times the steps."""
    tr = _trainer(scene, tmp_path, "render")
    tr.check_iter = 2
    tr.training(iters_crop=0, iters_all=2, log_every=2)
    img = tr.render_view(1, 2)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert os.path.isfile(os.path.join(tr.save_dir, "train_2_0_2.png"))
    with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert any(np.isfinite(r.get("psnr/render", np.nan)) for r in rows)
    out = tr.profile_steps(2)
    assert os.path.isfile(out["trace"])
    assert out["wall_ms"] > 0 and out["untraced_ms"] > 0
    assert tr.state.step == 7      # 2 trained, 1 warm-up, 2 untraced, 2 traced


def test_trainer_and_cli_refuse_cuda_without_a_card(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA refusal is moot")
    hp = hparams_from_dict(_cfg(scene))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer("nocard", hp, batch_size=B, dataset=scene,
                exps_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        t_train.main(["--jsonfile", "srncar_fused.json", "--exps_root",
                      str(tmp_path)])


@pytest.mark.parametrize("flag", ["--data_axis", "--model_axis",
                                  "--replica_axis"])
def test_train_cli_mesh_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1, item 12"):
        t_train.main(["--device", "cpu", "--exps_root", str(tmp_path),
                      flag, "2"])


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory, scene):
    root = tmp_path_factory.mktemp("torch_cli")
    data = str(root / "data")
    write_srn_layout(data, scene, cat="srn_cars", splits="cars_train")
    write_srn_layout(data, synthetic_scene(n_objects=1, n_views=3, H=16,
                                           W=16, seed=5),
                     cat="srn_cars", splits="cars_test")
    cfg = _cfg(scene, check_points=2, data={"cat": "srn_cars",
                                            "splits": "cars_train",
                                            "data_dir": data})
    (root / "tiny.json").write_text(json.dumps(cfg))
    return root


def _cli(root, module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", module, "--jsonfile", str(root / "tiny.json"),
         "--exps_root", str(root / "exps"), "--device", "cpu", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out


def test_train_then_optimize_cli_on_one_run_dir(cli_root):
    """(g) and the repair: ``python -m codenerf_tpu_torch.train`` writes
    ``<run>/ckpt/``, ``python -m codenerf_tpu_torch.optimize`` reads the
    latest checkpoint there — a bogus ``models.pth`` beside it is never
    opened — and writes finite results."""
    _cli(cli_root, "codenerf_tpu_torch.train", "--save_dir", "run",
         "--iters_crop", "2", "--iters_all", "4", "--batchsize", str(B),
         "--log_every", "2", "--check_iter", "0", "--microbatch", "32")
    run = cli_root / "exps" / "run"
    assert ckpt.latest_step(str(run / "ckpt")) == 4
    (run / "models.pth").write_bytes(b"not a checkpoint")
    _cli(cli_root, "codenerf_tpu_torch.optimize", "--saved_dir", "run",
         "--num_opts", "2", "--tgt_instances", "0")
    with open(run / "test" / "results.json") as f:
        res = json.load(f)
    assert len(res["per_object"]) == 1
    assert np.isfinite([res["mean_psnr"], res["mean_ssim"]]).all()
    state, sc, _ = ckpt.load_training_checkpoint(str(run / "ckpt"))
    assert sc.shape == (3, NET["latent_dim"])
    # a resumed CLI run continues from step 4
    out = _cli(cli_root, "codenerf_tpu_torch.train", "--save_dir", "run",
               "--iters_crop", "2", "--iters_all", "6", "--batchsize",
               str(B), "--log_every", "2", "--check_iter", "0")
    assert "resumed from step 4" in out.stdout
    assert ckpt.latest_step(str(run / "ckpt")) == 6
