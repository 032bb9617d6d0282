"""Stochastic (``--opt_rays``) and batched (``--opt_group``) code fitting
in the port (``codenerf_tpu_torch/optimization/codes_opt.py``,
``optimize.py``) against the JAX package on the CPU, at W=256 with two
shape blocks, latent size 32, 8 samples and 16×16 views.

- ``_normalize_rays_per_step`` and the step plan against JAX's on a table
  of sizes.
- A stochastic run of the port (single-pass route, plain version) against
  JAX ``optimize_codes(..., rays_per_step=...)`` (XLA route) on the same
  weights, with both samplers at the bin midpoints (the port is given a
  generator: without one it renders linspace depths) and the port fed
  the minibatch indices that JAX's key derivation draws. The bar is
  ``tests/test_torch_optimize.py``'s, for the same reason (bf16 rounding
  on one side, AdamW's ±lr first steps): history within 0.02 dB, codes
  within 1e-2.
- The batched run's row g against the port's standalone run of object g
  with the same generator, atol 1e-5 on the codes (JAX's bar,
  ``tests/test_fused_train.py``) and 1e-3 dB on the history: full view
  and minibatch, coarse and hierarchical, and the autodiff route on a
  padded pool.
- The optimize CLI with ``--opt_group 2`` against the sequential CLI,
  object for object; the progress-PNG warning of ``--opt_rays``.
- Refusals: a minibatch with progress renders, device ground truth
  without its geometry's leaves.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.core.rays import camera_rays as j_camera_rays
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu.optimization import codes_opt as j_codes_opt
from codenerf_tpu_torch import optimize as t_optimize
from codenerf_tpu_torch import renderer as t_renderer
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.data.synthetic import synthetic_scene, write_srn_layout
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.optimization import codes_opt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from export_reference_checkpoint import trainables_to_reference  # noqa: E402

D = 32
CFG = {
    "net_hyperparams": {"shape_blocks": 2, "texture_blocks": 1, "W": 256,
                        "num_xyz_freq": 6, "num_dir_freq": 2,
                        "latent_dim": D},
    "N_samples": 8, "near": 2.2, "far": 5.8, "use_fused_train": True,
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """W=256 on the CPU beside the other test workers: two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    jhp = j_hparams_from_dict(CFG)
    jparams = init_codenerf(jax.random.PRNGKey(0), jhp.net)
    hp = hparams_from_dict(CFG)
    model = CodeNeRF(hp.net).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    scene = synthetic_scene(n_objects=2, n_views=3, H=16, W=16, seed=3,
                            pattern=True)
    rays = []
    for g in range(2):
        ro, vd = j_camera_rays(16, 16, float(scene["focals"][g]),
                               jnp.asarray(scene["poses"][g, 0]))
        gt = scene["images"][g, 0].astype(np.float32).reshape(-1, 3) / 255.0
        rays.append((np.asarray(ro), np.asarray(vd), gt))
    rng = np.random.default_rng(5)
    init_s = (rng.normal(size=D) * 0.1).astype(np.float32)
    init_t = (rng.normal(size=D) * 0.1).astype(np.float32)
    return jhp, jparams, hp, model, rays, init_s, init_t


@pytest.mark.parametrize("req,n_rays", [
    (None, 256), (1, 256), (15, 256), (16, 256), (17, 256), (100, 256),
    (239, 256), (241, 256), (256, 256), (5000, 256), (4000, 16129),
    (16129, 16129)])
def test_normalize_rays_per_step_matches_jax(req, n_rays):
    """The tile rounding, the full-pool sentinel and the step plan (chunk
    = min(minibatch, the pool's chunk), enough chunks to hold it) equal
    JAX's ``_normalize_rays_per_step`` and ``_build_run`` arithmetic."""
    from codenerf_tpu.renderer import chunk_plan as j_chunk_plan

    want = j_codes_opt._normalize_rays_per_step(req, n_rays)
    got = codes_opt._normalize_rays_per_step(req, n_rays)
    assert got == want
    chunk, n_chunks, n_padded = j_chunk_plan(n_rays, 4096)
    if want is not None:
        chunk = min(want, chunk)
        n_chunks = -(-want // chunk)
        n_padded = chunk * n_chunks
    assert codes_opt.step_plan(n_rays, 4096, got) == (chunk, n_chunks,
                                                      n_padded)


@pytest.mark.parametrize("req", [0, -3])
def test_normalize_rays_per_step_refuses_like_jax(req):
    with pytest.raises(ValueError, match="positive"):
        j_codes_opt._normalize_rays_per_step(req, 256)
    with pytest.raises(ValueError, match="positive"):
        codes_opt._normalize_rays_per_step(req, 256)


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


def _jax_minibatches(key, num_opts: int, n_step: int, n_rays: int):
    """The indices JAX ``_build_run``'s stochastic step draws: the run key
    split into one key a step, each step key split into (selection, rest),
    ``randint(selection, (n_step,), 0, n_rays)``."""
    out = []
    for step_key in jax.random.split(key, num_opts):
        k_sel, _ = jax.random.split(step_key)
        out.append(np.asarray(jax.random.randint(k_sel, (n_step,), 0,
                                                 n_rays)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


@pytest.mark.parametrize("rays_per_step,chunk", [(64, 4096), (100, 64)])
def test_stochastic_run_matches_jax(nets, rays_per_step, chunk):
    """One object, 4 steps: ``(64, 4096)`` is one chunk of 64 rays a
    step; ``(100, 64)`` rounds to 112 and runs two chunks of 64 (128 rays
    drawn, the loss scale 1/(128·3))."""
    jhp, jparams, hp, model, rays, init_s, init_t = nets
    ro, vd, gt = rays[0]
    num_opts, key = 4, jax.random.PRNGKey(11)
    n_rays = ro.shape[0]
    mb = codes_opt._normalize_rays_per_step(rays_per_step, n_rays)
    _, _, n_step = codes_opt.step_plan(n_rays, chunk, mb)
    assert codes_opt.codes_route(hp, n_rays, chunk, None,
                                 rays_per_step) == "single_pass"
    mp = pytest.MonkeyPatch()
    try:
        import codenerf_tpu.renderer as j_renderer

        mp.setattr(j_renderer, "stratified_zvals", _midpoints_jax)
        mp.setattr(t_renderer, "stratified_zvals", _midpoints_torch)
        j_codes_opt._RUN_CACHE.clear()
        want = j_codes_opt.optimize_codes(
            jparams, jhp, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(gt),
            jnp.asarray(init_s), jnp.asarray(init_t), key,
            num_opts=num_opts, chunk=chunk, use_fused=False,
            rays_per_step=rays_per_step)
        j_codes_opt._RUN_CACHE.clear()
        got = codes_opt.optimize_codes(
            model, hp, *(torch.from_numpy(x.copy()) for x in (ro, vd, gt)),
            torch.from_numpy(init_s), torch.from_numpy(init_t),
            torch.Generator(), num_opts=num_opts, chunk=chunk,
            rays_per_step=rays_per_step, pix=_jax_minibatches(key, num_opts, n_step, n_rays))
    finally:
        mp.undo()
    assert got.psnr_history.shape == (num_opts,)
    assert np.abs(got.shape_code.numpy() - init_s).max() > 1e-2
    np.testing.assert_allclose(got.psnr_history,
                               np.asarray(want.psnr_history), atol=0.02)
    np.testing.assert_allclose(got.shape_code.numpy(),
                               np.asarray(want.shape_code), atol=1e-2)
    np.testing.assert_allclose(got.texture_code.numpy(),
                               np.asarray(want.texture_code), atol=1e-2)


@pytest.mark.parametrize("case", ["full", "full_hier", "stochastic",
                                  "stochastic_hier", "autodiff_padded"])
def test_batched_rows_follow_standalone_runs(nets, case):
    """Row g of :func:`optimize_codes_batch` against
    :func:`optimize_codes` on object g alone with a generator seeded the
    same (jittered depths, importance probes and minibatches all drawn):
    codes within 1e-5 and history within 1e-3 dB."""
    _, _, hp, model, rays, init_s, init_t = nets
    kw = dict(num_opts=3, lr=1e-2, lr_half_interval=2, chunk=128)
    if case.endswith("hier"):
        hp = dataclasses.replace(hp, render=dataclasses.replace(
            hp.render, n_importance=8))
    if case.startswith("stochastic"):
        kw["rays_per_step"] = 48
    n_rays = 256
    if case == "autodiff_padded":
        hp = dataclasses.replace(hp, use_fused_train=False)
        n_rays, kw["chunk"] = 200, 128     # 2 chunks of 128, 56 pad rays
    route = codes_opt.codes_route(hp, n_rays, kw["chunk"], None,
                                  kw.get("rays_per_step"))
    assert route == ("autodiff" if case == "autodiff_padded"
                     else "single_pass")
    ro, vd, gt = (torch.from_numpy(np.stack([r[i][:n_rays] for r in rays]))
                  for i in range(3))
    s0, t0 = torch.from_numpy(init_s), torch.from_numpy(init_t)
    gens = lambda: [torch.Generator().manual_seed(100 + g)  # noqa: E731
                    for g in range(2)]
    batch = codes_opt.optimize_codes_batch(model, hp, ro, vd, gt, s0, t0,
                                           gens(), **kw)
    assert batch.shape_codes.shape == (2, D)
    assert batch.psnr_history.shape == (3, 2)
    assert np.isfinite(batch.psnr_history).all()
    for g, gen in enumerate(gens()):
        seq = codes_opt.optimize_codes(model, hp, ro[g], vd[g], gt[g], s0,
                                       t0, gen, **kw)
        np.testing.assert_allclose(batch.shape_codes[g].numpy(),
                                   seq.shape_code.numpy(), atol=1e-5)
        np.testing.assert_allclose(batch.texture_codes[g].numpy(),
                                   seq.texture_code.numpy(), atol=1e-5)
        np.testing.assert_allclose(batch.psnr_history[:, g],
                                   seq.psnr_history, atol=1e-3)
    # Not vacuous: the two objects moved differently.
    assert (batch.shape_codes[0] - batch.shape_codes[1]).abs().max() > 1e-3


def test_full_pool_budget_is_the_full_view(nets):
    """A minibatch as large as the pool is the exact full-view protocol:
    the same bits as ``rays_per_step=None`` (JAX's test (c))."""
    _, _, hp, model, rays, init_s, init_t = nets
    ro, vd, gt = (torch.from_numpy(x.copy()) for x in rays[0])
    runs = [codes_opt.optimize_codes(
        model, hp, ro, vd, gt, torch.from_numpy(init_s),
        torch.from_numpy(init_t), torch.Generator().manual_seed(4),
        num_opts=2, rays_per_step=r) for r in (256, None)]
    assert torch.equal(runs[0].shape_code, runs[1].shape_code)
    np.testing.assert_array_equal(runs[0].psnr_history,
                                  runs[1].psnr_history)


def test_minibatch_refuses_progress(nets):
    """Progress renders need the full view every step (JAX raises the
    same ``ValueError``), in ``optimize_codes`` and ``CodeOptimizer``."""
    _, _, hp, model, rays, init_s, init_t = nets
    ro, vd, gt = (torch.from_numpy(x.copy()) for x in rays[0])
    with pytest.raises(ValueError, match="progress"):
        codes_opt.optimize_codes(
            model, hp, ro, vd, gt, torch.from_numpy(init_s),
            torch.from_numpy(init_t), None, num_opts=1, progress_rays=16,
            rays_per_step=32)
    opt = codes_opt.CodeOptimizer(model, hp, torch.from_numpy(init_s),
                                  torch.from_numpy(init_t), device="cpu",
                                  opt_rays=32)
    scene = synthetic_scene(n_objects=1, n_views=2, H=16, W=16, seed=3)
    with pytest.raises(ValueError, match="progress_images"):
        opt.optimize_object(scene["images"][0], scene["poses"][0],
                            float(scene["focals"][0]), [0], None,
                            num_opts=1, progress_images=True)


def test_unported_batch_options_raise(nets):
    """Ground truth rendered on the device from parameters that lack a
    leaf of their geometry (a sphere without ``radius``) raises and names
    it (the object mesh runs: tests/test_torch_sharding_fit.py)."""
    _, _, hp, model, _, init_s, init_t = nets
    s0, t0 = torch.from_numpy(init_s), torch.from_numpy(init_t)
    opt = codes_opt.CodeOptimizer(model, hp, s0, t0, device="cpu")
    scene = synthetic_scene(n_objects=1, n_views=2, H=16, W=16, seed=3,
                            params_only=True)
    with pytest.raises(ValueError, match="radius"):
        opt.evaluate_objects(None, scene["poses"], scene["focals"], [0],
                             s0[None], t0[None], [None],
                             gt_params={"albedo": scene["albedos"],
                                        "geometry": "sphere",
                                        "pattern": False, "hw": (16, 16)})


def test_padded_pool_minibatch_takes_the_single_pass(nets):
    """A 127×127 view (16,129 rays) pads its full-view chunks and takes
    the plane op with the standalone composite; a minibatch of it has no
    pad rays and takes the single pass (JAX ``codes_opt.py:258-262``)."""
    hp = nets[2]
    assert codes_opt.codes_route(hp, 127 * 127, 4096) == "plane_op_composite"
    assert codes_opt.codes_route(hp, 127 * 127, 4096, None,
                                 1000) == "single_pass"


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, nets):
    """Three objects in the SRN layout and a ``models.pth`` run."""
    jhp, jparams, *_ = nets
    root = tmp_path_factory.mktemp("opt_group")
    scene = synthetic_scene(n_objects=3, n_views=3, H=16, W=16, seed=0)
    write_srn_layout(str(root / "data"), scene, cat="srn_cars",
                     splits="cars_test")
    cfg = dict(CFG, data={"cat": "srn_cars", "splits": "cars_train",
                          "data_dir": str(root / "data")},
               near=float(scene["near"]), far=float(scene["far"]))
    jsonfile = root / "tiny_fused.json"
    jsonfile.write_text(json.dumps(cfg))
    trainables = jax.tree_util.tree_map(np.asarray, {
        "params": jparams,
        "shape_codes": init_codes(jax.random.PRNGKey(1), 4, D),
        "texture_codes": init_codes(jax.random.PRNGKey(2), 4, D)})
    os.makedirs(root / "exps" / "run")
    torch.save(trainables_to_reference(trainables),
               root / "exps" / "run" / "models.pth")
    base = ["--device", "cpu", "--jsonfile", str(jsonfile), "--exps_root",
            str(root / "exps"), "--saved_dir", "run", "--num_opts", "3",
            "--tgt_instances", "0", "--save_progress", "false"]
    return base


def _outputs(out):
    codes = np.load(os.path.join(out["save_dir"], "codes.npz"))
    with open(os.path.join(out["save_dir"], "results.json")) as f:
        return codes, json.load(f)


@pytest.mark.parametrize("extra", [[], ["--opt_rays", "64"]])
def test_batched_cli_matches_sequential(cli_run, extra):
    """``--opt_group 2`` over three objects (a group of two, then one)
    writes ``codes.npz`` and ``results.json`` object for object as the
    sequential CLI does: codes within 1e-5, eval PSNR within 1e-3 dB and
    SSIM within 1e-5, the same ids, schema and eval images."""
    seq = t_optimize.main(cli_run + extra)
    bat = t_optimize.main(cli_run + extra + ["--opt_group", "2"])
    (c_s, r_s), (c_b, r_b) = _outputs(seq), _outputs(bat)
    np.testing.assert_array_equal(c_s["ids"], c_b["ids"])
    for k in ("optimized_shapecodes", "optimized_texturecodes"):
        assert np.abs(c_s[k]).max() > 0
        np.testing.assert_allclose(c_b[k], c_s[k], atol=1e-5)
    assert set(r_b) == set(r_s)
    assert [r["id"] for r in r_b["per_object"]] == [
        r["id"] for r in r_s["per_object"]] == ["obj0000", "obj0001",
                                                "obj0002"]
    for obj_id in r_s["psnr_eval"]:
        np.testing.assert_allclose(r_b["psnr_eval"][obj_id],
                                   r_s["psnr_eval"][obj_id], atol=1e-3)
        np.testing.assert_allclose(r_b["ssim_eval"][obj_id],
                                   r_s["ssim_eval"][obj_id], atol=1e-5)
        np.testing.assert_allclose(bat["psnr_history"][obj_id],
                                   seq["psnr_history"][obj_id], atol=1e-3)
        assert sorted(os.listdir(os.path.join(bat["save_dir"], obj_id))) \
            == sorted(os.listdir(os.path.join(seq["save_dir"], obj_id)))
    assert bat["timing"]["opt_steps"] == seq["timing"]["opt_steps"] == 9


def test_opt_rays_cli_drops_progress_with_a_warning(cli_run, capsys):
    """``--opt_rays`` with progress PNGs on (the default) warns as the JAX
    CLI does and writes none."""
    args = [a for a in cli_run if a not in ("--save_progress", "false")]
    out = t_optimize.main(args + ["--opt_rays", "64", "--max_objects", "1"])
    assert "WARNING: --opt_rays disables per-step progress PNGs" in \
        capsys.readouterr().err
    files = os.listdir(os.path.join(out["save_dir"], "obj0000"))
    assert files and not any(f.startswith("opt") for f in files)
