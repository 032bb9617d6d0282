"""The port's quality report (``python -m codenerf_tpu_torch.quality_report``)
on the CPU at a narrow width: W=64, 16×16 views, 6 training steps of 256
rays, 2 training objects and 1 held-out object, two seeds.

- ``run_once`` runs the whole protocol (scene, training, fitting, eval)
  and writes ``RESULTS.md`` and the held-out strip.
- The ``RESULTS.md`` / ``SUMMARY.md`` layout against the JAX tool's own
  writer (``tools/quality_report.py``): the JAX tool is run with its
  trainer and code optimizer replaced by stand-ins that replay the port's
  per-seed rows, and a clock that advances a fixed step a call; the port's
  writers, given the same rows and seconds, must write the same text.
- Reruns on the trained checkpoint (``--resume_train``) with
  ``--opt_group 2`` give the sequential rows; with ``--opt_rays`` they
  run the stochastic fit.
- ``--scene_backend jax`` (the port's ``device``) and ``--device_gt``
  without ``--opt_group`` > 1 raise.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from codenerf_tpu_torch import quality_report as t_tool
from codenerf_tpu_torch.config import NetConfig

NET = NetConfig(shape_blocks=2, texture_blocks=1, W=64, num_xyz_freq=6,
                num_dir_freq=2, latent_dim=32)
ARGV = ["--steps", "6", "--num_opts", "4", "--n_train_objects", "2",
        "--n_test_objects", "1", "--n_views", "4", "--size", "16",
        "--samples", "16", "--seeds", "0,1"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(args, seed, out):
    return t_tool.run_once(args, seed, out, net=NET, batch_size=256,
                           device="cpu")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("quality_port")
    args = t_tool.build_parser().parse_args(
        ARGV + ["--out", str(out), "--device", "cpu"])
    results = [_run(args, s, str(out / f"seed{s}")) for s in (0, 1)]
    return args, out, results


def test_run_once_writes_the_report(port_runs):
    _, out, results = port_runs
    for r in results:
        assert r["rows"] and np.isfinite(
            [v for row in r["rows"] for v in row[1:]]).all()
        assert np.isfinite([r["psnr"], r["ssim"], r["train_psnr"]]).all()
        assert len(r["fit_s"]) == 1
        seed_dir = out / f"seed{r['seed']}"
        text = (seed_dir / "RESULTS.md").read_text()
        name, p, s, h0, h1 = r["rows"][0]
        assert (f"| {name} | {p:.2f} | {s:.4f} | {h0:.1f} -> {h1:.1f} |"
                in text)
        assert "W=64, 2+1 blocks, 16 samples/ray" in text
        assert (seed_dir / "heldout_0.png").exists()
        assert os.path.isdir(os.path.join(r["run_dir"], "ckpt"))
    # The two seeds draw different categories.
    assert results[0]["rows"] != results[1]["rows"]


class _Clock:
    """``time.time`` of the JAX tool: a fixed step a call."""

    def __init__(self, step):
        self.t, self.step = 1000.0, step

    def time(self):
        self.t += self.step
        return self.t


def test_layout_matches_the_jax_writer(port_runs, tmp_path, monkeypatch):
    args, _, results = port_runs
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import quality_report as j_tool

    import codenerf_tpu.optimization.codes_opt as j_codes_opt
    import codenerf_tpu.training.trainer as j_trainer
    import codenerf_tpu.utils.cache as j_cache

    by_seed = {r["seed"]: r for r in results}
    current = {}

    class FakeTrainer:
        def __init__(self, name, hp, **kw):
            current["r"] = by_seed[hp.seed]
            self.occupancy_grid = None
            self.state = types.SimpleNamespace(trainables={
                "params": None, "shape_codes": np.zeros((2, 32)),
                "texture_codes": np.zeros((2, 32))})

        def resume(self):
            return False

        def training(self, **kw):
            return {"psnr": current["r"]["train_psnr"]}

    class FakeOptimizer:
        def __init__(self, **kw):
            self.i = 0

        def optimize_object(self, *a, **kw):
            _, _, _, h0, h1 = current["r"]["rows"][self.i]
            return types.SimpleNamespace(shape_code=None, texture_code=None,
                                         psnr_history=np.array([h0, h1]))

        def evaluate_object(self, *a, **kw):
            _, p, s, _, _ = current["r"]["rows"][self.i]
            self.i += 1
            return {"psnr": np.array([p]), "ssim": np.array([s]),
                    "views": np.array([0])}

    step = 7.25
    monkeypatch.setattr(j_trainer, "Trainer", FakeTrainer)
    monkeypatch.setattr(j_codes_opt, "CodeOptimizer", FakeOptimizer)
    monkeypatch.setattr(j_cache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(j_tool, "time", _Clock(step))
    argv = [a for a in ARGV] + ["--out", str(tmp_path / "jax"),
                                "--save_images", "0"]
    monkeypatch.setattr(sys, "argv", ["quality_report.py"] + argv)
    j_tool.main()

    # The JAX tool reads the clock at training start and end and at the
    # test split's start and end: every wall reads one step.
    for r in results:
        seed = r["seed"]
        scene = t_tool.load_scenes(args, seed)[0]
        hp = t_tool.flagship_hparams(args, seed, scene)
        path = tmp_path / f"port_results{seed}.md"
        t_tool.write_results(str(path), args, hp, seed, r["rows"], step,
                             r["train_psnr"], step, [1])
        want = (tmp_path / "jax" / f"seed{seed}" / "RESULTS.md").read_text()
        assert path.read_text() == want
    timed = [dict(r, train_s=step) for r in results]
    path = tmp_path / "port_summary.md"
    t_tool.write_summary(str(path), args, [0, 1], timed)
    assert path.read_text() == (tmp_path / "jax" / "SUMMARY.md").read_text()


def test_reruns_on_the_trained_checkpoint(port_runs):
    """``--resume_train`` skips training (the checkpoint is at --steps);
    ``--opt_group 2`` fits through the batched path with the sequential
    run's generators: the same rows. ``--opt_rays 64`` runs the
    stochastic fit."""
    _, out, results = port_runs
    seq = results[0]
    base = ARGV[:-2] + ["--seeds", "0", "--resume_train", "--device", "cpu"]
    group = _run(t_tool.build_parser().parse_args(base + ["--opt_group", "2"]),
                 0, str(out / "seed0"))
    for got, want in zip(group["rows"], seq["rows"]):
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1:], want[1:], atol=1e-3)
    rays = _run(t_tool.build_parser().parse_args(base + ["--opt_rays", "64"]),
                0, str(out / "seed0"))
    assert np.isfinite([v for row in rays["rows"] for v in row[1:]]).all()
    assert rays["rows"][0][3] != seq["rows"][0][3]   # a minibatch's PSNR


@pytest.mark.parametrize("flag", [["--scene_backend", "jax"],
                                  ["--device_gt"]])
def test_device_renderer_flags_raise(flag, tmp_path, capsys):
    """The JAX tool's ``--scene_backend jax`` is spelled ``device`` here
    (argparse refuses it and names the choices), and ``--device_gt``
    without ``--opt_group`` > 1 raises before any work, as the JAX tool
    refuses it."""
    argv = ["--device", "cpu", "--out", str(tmp_path)] + flag
    if flag == ["--device_gt"]:
        with pytest.raises(ValueError, match="opt_group"):
            t_tool.main(argv)
    else:
        with pytest.raises(SystemExit):
            t_tool.main(argv)
        err = capsys.readouterr().err
        assert "invalid choice: 'jax'" in err and "device" in err
    assert not os.listdir(tmp_path)
