"""Shape/texture editing in the port against the JAX package, on the same
weights (``models/codenerf.params_from_jax``), codes and camera, at W=64,
2 + 1 blocks, 16 samples and 16×16 views: ``interpolate_codes`` (exact),
``render_code_grid`` (coarse, and hierarchical with a separate fine
network) and ``render_shape_texture_matrix``; then ``python -m
codenerf_tpu_torch.edit`` on a tiny run on the CPU (its outputs, the
swap matrix's diagonal equal to direct renders, and JAX's refusals).

Tolerance of the renders: within 2e-3 per pixel — the render bar of
``tests/test_torch_hier.py`` (the plain bf16 model rounds at different
points in XLA and PyTorch). ``interpolate_codes`` is exact: both compute
the JAX package's ``linspace`` and the same two f32 products and sum.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu.optimization import editing as j_editing
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.optimization import editing
from codenerf_tpu_torch.render_orbit import orbit_pose

NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 64, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": 32}
H = W = 16
RENDER_ATOL = 2e-3


def _pair(cfg, key):
    jparams = init_codenerf(jax.random.PRNGKey(key), j_hparams_from_dict(
        cfg).net)
    model = CodeNeRF(hparams_from_dict(cfg).net).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    return jparams, model


def _setup(hier: bool):
    cfg = {"net_hyperparams": NET, "N_samples": 16, "near": 0.8, "far": 1.8}
    if hier:
        cfg.update(N_importance=8, hierarchical_share_weights=False)
    jparams, model = _pair(cfg, 0)
    fine = _pair(cfg, 2) if hier else (None, None)
    codes = np.array(init_codes(jax.random.PRNGKey(1), 6, 32))
    return (j_hparams_from_dict(cfg), hparams_from_dict(cfg), jparams, model,
            fine, codes)


@pytest.mark.parametrize("n", [1, 2, 5, 7])
def test_interpolate_codes_exact(n):
    codes = np.array(init_codes(jax.random.PRNGKey(3), 2, 32))
    want = np.asarray(j_editing.interpolate_codes(
        jnp.asarray(codes[0]), jnp.asarray(codes[1]), n))
    got = editing.interpolate_codes(torch.from_numpy(codes[0]),
                                    torch.from_numpy(codes[1]), n).numpy()
    assert got.shape == (n, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hier", [False, True], ids=["coarse", "fine_net"])
def test_render_code_grid_matches_jax(hier):
    jhp, hp, jparams, model, (jfine, fine), codes = _setup(hier)
    c2w = orbit_pose(0.7, 0.3, 1.3)
    s, t = codes[:3], codes[3:]
    want = np.asarray(j_editing.render_code_grid(
        jparams, jhp, jnp.asarray(s), jnp.asarray(t), H, W, 20.0,
        jnp.asarray(c2w), chunk=128, fine_params=jfine))
    got = editing.render_code_grid(
        model, hp, torch.from_numpy(s), torch.from_numpy(t), H, W, 20.0,
        torch.from_numpy(c2w), chunk=128, fine_model=fine).numpy()
    assert got.shape == (3, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)


def test_render_shape_texture_matrix_matches_jax():
    jhp, hp, jparams, model, _, codes = _setup(False)
    c2w = orbit_pose(2.0, 0.4, 1.4)
    s, t = codes[:2], codes[2:5]
    want = np.asarray(j_editing.render_shape_texture_matrix(
        jparams, jhp, jnp.asarray(s), jnp.asarray(t), H, W, 18.0,
        jnp.asarray(c2w), chunk=256))
    got = editing.render_shape_texture_matrix(
        model, hp, torch.from_numpy(s), torch.from_numpy(t), H, W, 18.0,
        torch.from_numpy(c2w), chunk=256).numpy()
    assert got.shape == (2, 3, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)
    # row i column j is shape i with texture j
    one = editing.render_code_grid(
        model, hp, torch.from_numpy(s[1:2]), torch.from_numpy(t[2:3]), H, W,
        18.0, torch.from_numpy(c2w), chunk=256).numpy()
    np.testing.assert_array_equal(got[1, 2], one[0])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny port run (3 train objects, W=64) written by the trainer, and
    its jsonfile; shared by the CLI tests."""
    from test_torch_export import make_run

    return make_run(tmp_path_factory.mktemp("edit"))


def test_edit_cli(tiny_run):
    from codenerf_tpu_torch import edit
    from codenerf_tpu_torch.renderer import render_image
    from codenerf_tpu_torch.utils.checkpoint import load_run

    exps, run, jsonfile, hp = tiny_run
    res = edit.main(["--saved_dir", run, "--jsonfile", jsonfile,
                     "--exps_root", exps, "--objects", "0", "2", "--grid",
                     "3", "--device", "cpu"])
    for name in ("shape_interp.png", "texture_interp.png", "swap_matrix.png",
                 "results.json"):
        assert os.path.isfile(os.path.join(res["save_dir"], name)), name
    with open(os.path.join(res["save_dir"], "results.json")) as f:
        out = json.load(f)
    assert len(out["diag_psnr"]) == 2
    assert np.isfinite(out["mean_diag_psnr"])
    # the diagonal is the direct render of each object's own codes
    from codenerf_tpu_torch.data.srn import SRNDataset

    model, fine, sc, tc = load_run(os.path.join(exps, run), hp, "cpu")
    ds = SRNDataset(cat=hp.data.cat, splits=hp.data.splits,
                    data_dir=hp.data.data_dir, max_objects=3)
    H_, W_ = ds.images.shape[2:4]
    for j, oi in enumerate((0, 2)):
        direct = render_image(model, hp.render, H_, W_, float(ds.focals[0]),
                              torch.from_numpy(ds.poses[0, 0]), sc[oi],
                              tc[oi], None, chunk=min(4096, H_ * W_),
                              fine_model=fine).numpy()
        np.testing.assert_array_equal(res["matrix"][j, j], direct)
    again = edit.main(["--saved_dir", run, "--jsonfile", jsonfile,
                       "--exps_root", exps, "--grid", "2", "--device",
                       "cpu"])
    assert again["save_dir"].endswith("edits_2")


@pytest.mark.parametrize("objects,words", [
    (["0"], "at least two"), (["0", "9"], "out of range")])
def test_edit_cli_refuses(tiny_run, objects, words):
    from codenerf_tpu_torch import edit

    exps, run, jsonfile, _ = tiny_run
    with pytest.raises(SystemExit, match=words):
        edit.main(["--saved_dir", run, "--jsonfile", jsonfile, "--exps_root",
                   exps, "--objects", *objects, "--device", "cpu"])
