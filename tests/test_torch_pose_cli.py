"""The port's pose CLIs on the CPU: ``python -m codenerf_tpu_torch.pose_opt``
and ``python -m codenerf_tpu_torch.optimize --pose_opt`` as subprocesses
with ``--device cpu`` on a tiny hierarchical run (W=256 for the
single-pass kernel's plain version, 2+1 blocks, 16 + 16 samples with
sphere bounds, 64 rays per step on a 16×16 synthetic ``cars_test`` split),
and their seeded initial poses against the JAX tool's formula
(``tools/pose_opt.py:146-154``).

Tolerances: the initial poses within 1e-6 (f32 ``exp_se3`` of the two
libraries); the pose errors ``results.json`` reports before optimizing
within 1e-4 relative of the JAX-formula poses' (the same poses up to
that rounding).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.core import poses as j_poses
from codenerf_tpu.data.synthetic import synthetic_scene, write_srn_layout
from codenerf_tpu_torch import pose_opt as t_pose_cli
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.core.poses import exp_se3
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.utils.checkpoint import save_reference_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT = 32
NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 256, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": LATENT}


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A tiny hierarchical run in the reference layout (``models.pth``)
    and a seeded SRN-layout ``cars_test`` split of two objects."""
    scene = synthetic_scene(n_objects=2, n_views=3, H=16, W=16, seed=4)
    root = tmp_path_factory.mktemp("torch_pose_cli")
    data = str(root / "data")
    write_srn_layout(data, scene, cat="srn_cars", splits="cars_test")
    cfg = {"net_hyperparams": NET, "N_samples": 16, "N_importance": 16,
           "bound_sphere_radius": 1.4, "near": float(scene["near"]),
           "far": float(scene["far"]), "use_fused_train": True,
           "data": {"cat": "srn_cars", "splits": "cars_train",
                    "data_dir": data}}
    (root / "pose_hier.json").write_text(json.dumps(cfg))
    run = root / "exps" / "run"
    run.mkdir(parents=True)
    torch.manual_seed(0)
    model = CodeNeRF(hparams_from_dict(cfg).net)
    codes = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, LATENT)).astype(np.float32) * 0.3)
    save_reference_checkpoint(str(run / "models.pth"), model, codes,
                              codes.flip(0))
    return root


def _cli(root, module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", module, "--jsonfile",
         str(root / "pose_hier.json"), "--exps_root", str(root / "exps"),
         "--saved_dir", "run", "--device", "cpu", "--num_opts", "3",
         "--rays_per_step", "64", "--seed", "3", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out


def _jax_initial_poses(root, n_objects, seed, rot, trans, view=1):
    """The JAX tool's perturbation formula (``tools/pose_opt.py:146-154``)
    on the same poses: its initial guesses."""
    from codenerf_tpu.data.srn import SRNDataset

    ds = SRNDataset(cat="srn_cars", splits="cars_test",
                    data_dir=str(root / "data"))
    rng = np.random.default_rng(seed)
    out = []
    for oi in range(n_objects):
        gt = np.asarray(ds.poses[oi, view], np.float32)
        ax = rng.standard_normal(3)
        ax /= np.linalg.norm(ax)
        dxyz = rng.standard_normal(3)
        dxyz /= np.linalg.norm(dxyz)
        xi = np.concatenate([ax * np.radians(rot), dxyz * trans]).astype(
            np.float32)
        out.append((np.asarray(j_poses.exp_se3(jnp.asarray(xi)) @ gt), gt))
    return out


def test_pose_cli_and_optimize_dispatch(cli_root):
    """``python -m codenerf_tpu_torch.pose_opt`` and ``python -m
    codenerf_tpu_torch.optimize --pose_opt`` with the same flags write
    the same finite ``results.json`` (and the PNG strips); the initial
    pose errors are those of the JAX tool's seeded perturbations."""
    _cli(cli_root, "codenerf_tpu_torch.pose_opt")
    _cli(cli_root, "codenerf_tpu_torch.optimize", "--pose_opt")
    run = cli_root / "exps" / "run"
    res = []
    for d in ("pose_opt", "pose_opt_2"):
        with open(run / d / "results.json") as f:
            res.append(json.load(f))
        assert {"obj0000.png", "obj0001.png"} <= set(os.listdir(run / d))
    rows = res[0]["per_object"]
    assert len(rows) == 2 and rows == res[1]["per_object"]
    for row in rows:
        assert np.isfinite([v for k, v in row.items() if k != "id"]).all()
    assert np.isfinite([res[0]["mean_rot_err_deg_after"],
                        res[0]["mean_trans_err_after"]]).all()
    assert res[0]["args"]["num_opts"] == 3
    for row, (init, gt) in zip(rows, _jax_initial_poses(cli_root, 2, 3, 6.0,
                                                        0.1)):
        np.testing.assert_allclose(row["rot_err_deg_before"],
                                   t_pose_cli.rotation_error_deg(init, gt),
                                   rtol=1e-4)
        np.testing.assert_allclose(row["trans_err_before"],
                                   t_pose_cli.translation_error(init, gt),
                                   rtol=1e-4)
        np.testing.assert_allclose(row["rot_err_deg_before"], 6.0, rtol=1e-3)


def test_initial_poses_match_the_jax_tool(cli_root):
    """The port's perturbation (its own copy of the tool's helpers) gives
    the JAX tool's initial poses for the same seed."""
    rng = np.random.default_rng(3)
    for init_w, gt in _jax_initial_poses(cli_root, 2, 3, 6.0, 0.1):
        xi = t_pose_cli.perturbation_twist(rng, 6.0, 0.1)
        init = (exp_se3(torch.from_numpy(xi)) @ torch.from_numpy(gt)).numpy()
        np.testing.assert_allclose(init, init_w, rtol=0, atol=1e-6)


def test_pose_cli_refuses_cuda_without_a_card(cli_root):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA refusal is moot")
    with pytest.raises(RuntimeError, match="cuda"):
        t_pose_cli.main(["--jsonfile", str(cli_root / "pose_hier.json"),
                         "--exps_root", str(cli_root / "exps"),
                         "--saved_dir", "run"])
