"""The train and optimize CLIs of the port on two ``gloo`` ranks
(``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
codenerf_tpu_torch.train|optimize ... --device cpu``) against the same
CLIs in one process, at ``test_torch_sharding.py``'s bars (the kernels'
bf16 route: losses rtol 1e-4, the checkpoint's weights within a relative
L2 error of 2e-2 of the training's update) and the fitting bars of
``test_torch_sharding_fit.py`` (codes atol 1e-5, PSNR 1e-3, SSIM 1e-4).
Rank 0 alone writes: each file once, in one run directory. ``train
--model_axis 2`` on two ranks (the autodiff route at latent 256, so that
the code tables are split too) repeats one process bit for bit: every
rank runs one process's arithmetic, one thread each."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_sharding import B, cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--iters_crop", "2", "--iters_all", "4", "--batchsize", str(B),
         "--log_every", "1", "--check_iter", "0"]
OPTIMIZE = ["--opt_group", "2", "--num_opts", "2", "--tgt_instances", "0",
            "--batchsize", "128"]


def _run(root, module, *args, ranks=1, jsonfile="tiny.json"):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(ranks)] if ranks > 1
              else [sys.executable])
    out = subprocess.run(
        launch + ["-m", module, "--jsonfile", str(root / jsonfile),
                  "--exps_root", str(root / "exps"), "--device", "cpu",
                  *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One- and two-rank runs of both CLIs: training from scratch, then
    fitting the one-process run's checkpoint (twice, into ``test`` and
    ``test_2``)."""
    from codenerf_tpu_torch.data.synthetic import (synthetic_scene,
                                                   write_srn_layout)

    root = tmp_path_factory.mktemp("sharded_cli")
    data = str(root / "data")
    write_srn_layout(data, synthetic_scene(n_objects=3, n_views=4, H=16,
                                           W=16, seed=0),
                     cat="srn_cars", splits="cars_train")
    write_srn_layout(data, synthetic_scene(n_objects=2, n_views=3, H=16,
                                           W=16, seed=5),
                     cat="srn_cars", splits="cars_test")
    cfg = cfg_dict(check_points=2, data={"cat": "srn_cars",
                                         "splits": "cars_train",
                                         "data_dir": data})
    (root / "tiny.json").write_text(json.dumps(cfg))
    tp = dict(cfg, use_fused_train=False,
              net_hyperparams=dict(cfg["net_hyperparams"], latent_dim=256))
    (root / "autodiff.json").write_text(json.dumps(tp))
    _run(root, "codenerf_tpu_torch.train", "--save_dir", "one", *TRAIN)
    _run(root, "codenerf_tpu_torch.train", "--save_dir", "tp_one", *TRAIN,
         jsonfile="autodiff.json")
    _run(root, "codenerf_tpu_torch.train", "--save_dir", "tp_two", *TRAIN,
         "--model_axis", "2", ranks=2, jsonfile="autodiff.json")
    _run(root, "codenerf_tpu_torch.train", "--save_dir", "two", *TRAIN,
         "--data_axis", "2", ranks=2)
    _run(root, "codenerf_tpu_torch.optimize", "--saved_dir", "one",
         *OPTIMIZE)
    _run(root, "codenerf_tpu_torch.optimize", "--saved_dir", "one",
         *OPTIMIZE, ranks=2)
    return root


def _losses(run):
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["loss/train"]) for r in rows]


def _weights(run):
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    state = ckpt.read_checkpoint(str(run / "ckpt"))
    return torch.cat([v.reshape(-1).float() for v in state["model"].values()]
                     + [state["shape_codes"].reshape(-1),
                        state["texture_codes"].reshape(-1)]).numpy()


def test_train_cli_two_ranks_matches_one_process(root):
    """Two ranks × 4 steps through ``train`` (``--data_axis 2``): every
    logged loss of the one-process run, each step once; the same
    checkpoints, whose weights moved alike."""
    one, two = root / "exps" / "one", root / "exps" / "two"
    want, got = _losses(one), _losses(two)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    assert sorted(os.listdir(two / "ckpt")) == sorted(os.listdir(one / "ckpt"))
    assert sorted(os.listdir(two)) == sorted(
        d for d in os.listdir(one) if not d.startswith("test"))
    start = _first_weights(root)
    w1, w2 = _weights(one), _weights(two)
    rel = np.linalg.norm(w2 - w1) / np.linalg.norm(w1 - start)
    assert rel < 2e-2, rel


def test_train_cli_model_axis_matches_one_process(root):
    """``train --model_axis 2`` on two ranks: the one-process run's
    logged losses and every checkpoint, whole on disk, tensor for tensor
    (weights, code tables, AdamW moments, generator), each written
    once."""
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    one, two = root / "exps" / "tp_one", root / "exps" / "tp_two"
    assert _losses(two) == _losses(one)
    assert [s for s, _ in _losses(one)] == [1, 2, 3, 4]
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    names = sorted(os.listdir(one / "ckpt"))
    assert sorted(os.listdir(two / "ckpt")) == names == [
        "step_00000002.pt", "step_00000004.pt"]
    for step in (2, 4):
        a = ckpt.read_checkpoint(str(one / "ckpt"), step)
        b = ckpt.read_checkpoint(str(two / "ckpt"), step)
        assert b["shape_codes"].shape == (3, 256)
        for key in ("model", "shape_codes", "texture_codes", "generator"):
            x, y = a[key], b[key]
            for k in (x if isinstance(x, dict) else [None]):
                u, v = (x, y) if k is None else (x[k], y[k])
                assert torch.equal(u, v), (step, key, k)
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (step, i, k)
    start = _first_weights(root, "autodiff.json")
    assert np.abs(_weights(two) - start).max() > 1e-4


def _first_weights(root, jsonfile="tiny.json"):
    """The state both runs start from: the seed's, before any step."""
    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.training.state import create_train_state

    st = create_train_state(load_hparams(str(root / jsonfile)), 3, "cpu")
    return torch.cat([p.detach().reshape(-1) for p in st.model.parameters()]
                     + [st.shape_codes.detach().reshape(-1),
                        st.texture_codes.detach().reshape(-1)]).numpy()


def test_optimize_cli_two_ranks_matches_one_process(root):
    """``optimize --opt_group 2`` on two ranks (one object each) writes the
    one-process run's files once (``test_2``, no third directory) with the
    same codes and scores."""
    run = root / "exps" / "one"
    assert sorted(d for d in os.listdir(run) if d.startswith("test")) == [
        "test", "test_2"]
    one, two = run / "test", run / "test_2"
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    for obj in ("obj0000", "obj0001"):
        assert sorted(os.listdir(two / obj)) == sorted(os.listdir(one / obj))
    a, b = np.load(one / "codes.npz"), np.load(two / "codes.npz")
    for k in ("optimized_shapecodes", "optimized_texturecodes"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-5)
    assert np.abs(a["optimized_shapecodes"]).max() > 0
    with open(one / "results.json") as f:
        want = json.load(f)
    with open(two / "results.json") as f:
        got = json.load(f)
    for k in ("psnr_eval", "ssim_eval"):
        assert got[k].keys() == want[k].keys()
        for obj in want[k]:
            np.testing.assert_allclose(got[k][obj], want[k][obj],
                                       atol=1e-3 if k == "psnr_eval"
                                       else 1e-4)
