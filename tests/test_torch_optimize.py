"""The slice as a whole on the CPU: the port's optimize CLI
(``codenerf_tpu_torch.optimize.main``, fused-kernel route, plain version)
against the JAX ``CodeOptimizer`` (XLA route) on the same tiny SRN-layout
data and the same weights (``models.pth`` exported from JAX-initialized
trainables).

Both packages' stratified samplers are patched to the bin midpoints (zero
jitter), so the two trajectories see the same depths step by step. The JAX
XLA route rounds differently from the fused kernel (bf16 bias adds), and
AdamW's first steps move each code component by about ±lr whatever the
gradient's size, so a component whose gradient is near zero can differ by
a sizeable share of lr. Measured: PSNR history within 1e-4 dB, codes within
1.1e-3 (lr is 1e-2), eval PSNR within 2e-4 dB and SSIM within 1e-5. The
bar: history and eval PSNR within 0.02 dB, codes within 1e-2 (half a step
taken the other way), SSIM within 1e-3."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import load_hparams as j_load_hparams
from codenerf_tpu.data.synthetic import synthetic_scene, write_srn_layout
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.models.codes import init_codes, mean_code
from codenerf_tpu.optimization import codes_opt as j_codes_opt
from codenerf_tpu_torch import optimize as t_optimize
from codenerf_tpu_torch import renderer as t_renderer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from export_reference_checkpoint import trainables_to_reference  # noqa: E402

NUM_OPTS = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    scene = synthetic_scene(n_objects=2, n_views=3, H=16, W=16, seed=0)
    write_srn_layout(str(root / "data"), scene, cat="srn_cars",
                     splits="cars_test")
    cfg = {
        "net_hyperparams": {"shape_blocks": 2, "texture_blocks": 1, "W": 256,
                            "num_xyz_freq": 6, "num_dir_freq": 2,
                            "latent_dim": 32},
        "data": {"cat": "srn_cars", "splits": "cars_train",
                 "data_dir": str(root / "data")},
        "N_samples": 8, "near": float(scene["near"]),
        "far": float(scene["far"]), "use_fused_train": True,
    }
    jsonfile = root / "tiny_fused.json"
    jsonfile.write_text(json.dumps(cfg))
    hp = j_load_hparams(str(jsonfile))
    trainables = {
        "params": init_codenerf(jax.random.PRNGKey(0), hp.net),
        "shape_codes": init_codes(jax.random.PRNGKey(1), 4, 32),
        "texture_codes": init_codes(jax.random.PRNGKey(2), 4, 32),
    }
    trainables = jax.tree_util.tree_map(np.asarray, trainables)
    os.makedirs(root / "exps" / "run")
    torch.save(trainables_to_reference(trainables),
               root / "exps" / "run" / "models.pth")
    return root, scene, hp, trainables, str(jsonfile)


def _midpoints_jax(key, near, far, n_samples, num_rays=None, shared=False):
    half = (far - near) / (2.0 * n_samples)
    base = jnp.linspace(near + half, far - half, n_samples,
                        dtype=jnp.float32)
    return base if num_rays is None else jnp.broadcast_to(
        base, (num_rays, n_samples))


def _midpoints_torch(generator, near, far, n_samples, num_rays=None,
                     shared=False, jitter=None, device=None):
    half = (far - near) / (2.0 * n_samples)
    base = torch.linspace(near + half, far - half, n_samples, device=device)
    return base if num_rays is None else base.expand(num_rays, n_samples)


@pytest.fixture(scope="module")
def runs(setup):
    root, scene, hp, trainables, jsonfile = setup
    mp = pytest.MonkeyPatch()
    try:
        import codenerf_tpu.renderer as j_renderer

        mp.setattr(j_renderer, "stratified_zvals", _midpoints_jax)
        mp.setattr(t_renderer, "stratified_zvals", _midpoints_torch)
        j_codes_opt._RUN_CACHE.clear()
        out = t_optimize.main([
            "--device", "cpu", "--jsonfile", jsonfile,
            "--exps_root", str(root / "exps"), "--saved_dir", "run",
            "--num_opts", str(NUM_OPTS), "--tgt_instances", "0",
            "--deterministic_eval", "true"])
        opt = j_codes_opt.CodeOptimizer(
            params=trainables["params"], hp=hp,
            mean_shape=mean_code(jnp.asarray(trainables["shape_codes"])),
            mean_texture=mean_code(jnp.asarray(trainables["texture_codes"])),
            use_fused=False)
        jax_res = []
        for oi in range(scene["images"].shape[0]):
            imgs = scene["images"][oi]
            res = opt.optimize_object(imgs, scene["poses"][oi],
                                      float(scene["focals"][oi]), [0],
                                      jax.random.PRNGKey(oi),
                                      num_opts=NUM_OPTS)
            ev = opt.evaluate_object(imgs, scene["poses"][oi],
                                     float(scene["focals"][oi]), [0],
                                     res.shape_code, res.texture_code,
                                     jax.random.PRNGKey(9),
                                     deterministic=True)
            jax_res.append((res, ev))
        j_codes_opt._RUN_CACHE.clear()
    finally:
        mp.undo()
    return out, jax_res


def test_trajectory_and_eval_match_jax(runs, setup):
    out, jax_res = runs
    trainables = setup[3]
    save_dir = out["save_dir"]
    codes = np.load(os.path.join(save_dir, "codes.npz"))
    with open(os.path.join(save_dir, "results.json")) as f:
        results = json.load(f)
    for oi, (res, ev) in enumerate(jax_res):
        obj_id = f"obj{oi:04d}"
        hist = np.asarray(out["psnr_history"][obj_id])
        assert hist.shape == (NUM_OPTS,) and np.isfinite(hist).all()
        moved = codes["optimized_shapecodes"][oi] - np.mean(
            trainables["shape_codes"], axis=0)
        assert np.abs(moved).max() > 1e-2   # the comparison is not vacuous
        np.testing.assert_allclose(hist, np.asarray(res.psnr_history),
                                   atol=0.02)
        np.testing.assert_allclose(codes["optimized_shapecodes"][oi],
                                   np.asarray(res.shape_code), atol=1e-2)
        np.testing.assert_allclose(codes["optimized_texturecodes"][oi],
                                   np.asarray(res.texture_code), atol=1e-2)
        np.testing.assert_allclose(results["psnr_eval"][obj_id], ev["psnr"],
                                   atol=0.02)
        np.testing.assert_allclose(results["ssim_eval"][obj_id], ev["ssim"],
                                   atol=1e-3)


def test_outputs_have_the_jax_cli_schema(runs, setup):
    out, _ = runs
    save_dir = out["save_dir"]
    with open(os.path.join(save_dir, "results.json")) as f:
        results = json.load(f)
    assert set(results) == {"per_object", "psnr_eval", "ssim_eval",
                            "mean_psnr", "mean_ssim"}
    assert [row["id"] for row in results["per_object"]] == ["obj0000",
                                                            "obj0001"]
    assert all(set(row) == {"id", "psnr", "ssim"}
               for row in results["per_object"])
    assert all(len(v) == 2 for v in results["psnr_eval"].values())
    codes = torch.load(os.path.join(save_dir, "codes.pth"),
                       weights_only=False)
    assert set(codes) == {"ids", "num_obj", "optimized_shapecodes",
                          "optimized_texturecodes", "psnr_eval", "ssim_eval"}
    assert codes["num_obj"] == 1
    assert tuple(codes["optimized_shapecodes"].shape) == (2, 32)
    assert set(codes["psnr_eval"]) == {0, 1}
    with open(os.path.join(save_dir, "opt_hpams.json")) as f:
        assert json.load(f)["num_opts"] == NUM_OPTS
    for obj_id in ("obj0000", "obj0001"):
        files = set(os.listdir(os.path.join(save_dir, obj_id)))
        assert {f"opt{t:03d}_0.png" for t in range(NUM_OPTS)} <= files
        assert {"1_1.png", "2_1.png"} <= files


@pytest.mark.parametrize("flag", [["--data_axis", "2"],
                                  ["--replica_axis", "2"]])
def test_unported_flags_raise(flag, setup, monkeypatch):
    """The mesh flags in one process (no torchrun) ask for a layout that
    one process cannot hold and raise ``make_mesh``'s ``ValueError``
    before any process group exists (the flags under torchrun:
    tests/test_torch_sharding_cli.py; ``--opt_occ`` and ``--opt_samples``:
    tests/test_torch_hier.py; ``--pose_opt``: tests/test_torch_pose_opt.py;
    ``--opt_rays`` and ``--opt_group``:
    tests/test_torch_opt_rays_group.py)."""
    _, _, _, _, jsonfile = setup
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="device count 1|not divisible"):
        t_optimize.main(["--device", "cpu", "--jsonfile", jsonfile] + flag)
    assert not torch.distributed.is_initialized()


def test_unported_configs_raise(setup, tmp_path):
    """The plane-op and autodiff routes are ported (``fused_composite:
    false`` and ``use_fused_train: false`` run on this ``models.pth``
    run: tests/test_torch_plane_routes.py holds their numbers against
    JAX); a separate fine network needs fine weights, which a reference
    ``models.pth`` cannot hold, and is refused."""
    root, _, _, _, jsonfile = setup
    base = json.loads(open(jsonfile).read())
    args = ["--device", "cpu", "--exps_root", str(root / "exps"),
            "--saved_dir", "run", "--num_opts", "1", "--tgt_instances",
            "0", "--save_img", "false", "--save_progress", "false"]
    for extra in ({"fused_composite": False}, {"use_fused_train": False}):
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({**base, **extra}))
        out = t_optimize.main(["--jsonfile", str(path)] + args)
        assert np.isfinite([r["psnr"] for r in out["summary"]]).all()
    path.write_text(json.dumps({**base, "N_importance": 8,
                                "hierarchical_share_weights": False}))
    with pytest.raises(ValueError, match="no fine network"):
        t_optimize.main(["--jsonfile", str(path)] + args)
