"""The port's checkpoint export, orbit camera and bound-radius estimate
against the JAX package, and their CLIs on the CPU, on a tiny port run
(3 synthetic objects, W=64, 2 + 1 blocks, 16 samples, 16×16 views, two
training steps of ``python -m codenerf_tpu_torch.train``):

- the round trip: the run's checkpoint -> ``export_reference_checkpoint``
  -> the JAX package's ``tools/convert_reference_checkpoint.convert`` ->
  its Orbax checkpoint: every JAX parameter and both code tables bit-equal
  to the port's f32 values (transposes only), ``niter`` the step; the
  export read back by the port's ``load_reference_checkpoint`` and by
  ``load_run`` on a directory that holds only ``models.pth``; a
  checkpoint with a separate fine network refused;
- ``orbit_pose`` bit-equal to ``tools/render_orbit.orbit_pose`` (the same
  numpy operations);
- ``estimate_radius`` within 1e-4 of ``tools/estimate_bound_radius``'s on
  the same weights (JAX weights carried across; both renders round the
  plain bf16 model at different points, which moves the opaque set's
  quantile little);
- ``python -m codenerf_tpu_torch.render_orbit`` and
  ``.estimate_bound_radius`` with ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu_torch.config import hparams_from_dict, load_hparams
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.render_orbit import orbit_pose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 64, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": 32}


def make_run(root, **extra):
    """A port run of two steps on a 3-object SRN-layout set under
    ``root``: returns ``(exps_root, run name, jsonfile, port Hparams)``."""
    from codenerf_tpu_torch import train
    from codenerf_tpu_torch.data.synthetic import (synthetic_scene,
                                                   write_srn_layout)

    root = str(root)
    data = os.path.join(root, "data")
    scene = synthetic_scene(n_objects=3, n_views=3, H=16, W=16, seed=0)
    write_srn_layout(data, scene, cat="srn_cars", splits="cars_train")
    cfg = {"net_hyperparams": NET, "N_samples": 16,
           "near": float(scene["near"]), "far": float(scene["far"]),
           "check_points": 2, "bound_sphere_radius": 1.4,
           "data": {"cat": "srn_cars", "splits": "cars_train",
                    "data_dir": data}, **extra}
    jsonfile = os.path.join(root, "tiny.json")
    with open(jsonfile, "w") as f:
        json.dump(cfg, f)
    exps = os.path.join(root, "exps")
    train.main(["--jsonfile", jsonfile, "--exps_root", exps, "--save_dir",
                "run", "--iters_crop", "1", "--iters_all", "2",
                "--batchsize", "32", "--log_every", "1", "--check_iter",
                "0", "--device", "cpu"])
    return exps, "run", jsonfile, load_hparams(jsonfile)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    return make_run(tmp_path_factory.mktemp("export"))


def test_export_round_trip_through_the_jax_converter(tiny_run, tmp_path):
    from codenerf_tpu.utils.checkpoint import restore_raw
    from codenerf_tpu_torch.export_reference_checkpoint import main
    from codenerf_tpu_torch.utils.checkpoint import (load_reference_checkpoint,
                                                     read_checkpoint)
    from tools.convert_reference_checkpoint import convert

    exps, run, _, hp = tiny_run
    ckpt_dir = os.path.join(exps, run, "ckpt")
    pth = str(tmp_path / "out" / "models.pth")
    assert main([ckpt_dir, pth]) == pth
    ck = read_checkpoint(ckpt_dir)
    saved = torch.load(pth, map_location="cpu", weights_only=True)
    assert (saved["niter"], saved["nepoch"]) == (ck["step"], 0) == (2, 0)

    convert(pth, str(tmp_path / "jax"), shape_blocks=2, texture_blocks=1)
    raw = restore_raw(str(tmp_path / "jax" / "ckpt"))
    assert int(raw["step"]) == 2
    params = raw["trainables"]["params"]
    assert len(params) == len(ck["model"]) // 2
    for name, layer in params.items():
        np.testing.assert_array_equal(
            np.asarray(layer["w"]), ck["model"][f"{name}.weight"].numpy().T,
            err_msg=name)
        np.testing.assert_array_equal(np.asarray(layer["b"]),
                                      ck["model"][f"{name}.bias"].numpy())
    for k in ("shape_codes", "texture_codes"):
        np.testing.assert_array_equal(np.asarray(raw["trainables"][k]),
                                      ck[k].numpy())

    sd, sc, tc = load_reference_checkpoint(pth)
    assert sd.keys() == ck["model"].keys()
    assert all(torch.equal(sd[k], ck["model"][k]) for k in sd)
    assert torch.equal(sc, ck["shape_codes"])
    assert torch.equal(tc, ck["texture_codes"])


def test_export_latest_or_step_and_load_run(tiny_run, tmp_path):
    """``--step`` picks a checkpoint; a run directory holding only the
    exported ``models.pth`` loads through ``load_run``."""
    from codenerf_tpu_torch.export_reference_checkpoint import main
    from codenerf_tpu_torch.utils.checkpoint import load_run, read_checkpoint

    exps, run, _, hp = tiny_run
    ckpt_dir = os.path.join(exps, run, "ckpt")
    steps = sorted(int(f[5:13]) for f in os.listdir(ckpt_dir))
    one = str(tmp_path / "one" / "models.pth")
    main([ckpt_dir, one, "--step", str(steps[0])])
    saved = torch.load(one, map_location="cpu", weights_only=True)
    assert saved["niter"] == steps[0]
    ck = read_checkpoint(ckpt_dir, steps[0])
    model, fine, sc, tc = load_run(str(tmp_path / "one"), hp, "cpu")
    assert fine is None
    assert all(torch.equal(v, ck["model"][k])
               for k, v in model.state_dict().items())
    assert torch.equal(sc, ck["shape_codes"])


def test_export_refuses_a_separate_fine_network(tmp_path):
    """A checkpoint holding ``fine_model`` is refused with the reason, and
    nothing is written."""
    from codenerf_tpu_torch.config import NetConfig
    from codenerf_tpu_torch.export_reference_checkpoint import export
    from codenerf_tpu_torch.utils.checkpoint import step_path

    net = CodeNeRF(NetConfig(**NET))
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    torch.save({"model": net.state_dict(), "fine_model": net.state_dict(),
                "shape_codes": torch.zeros(2, 32),
                "texture_codes": torch.zeros(2, 32), "step": 3},
               step_path(ckpt_dir, 3))
    out = str(tmp_path / "models.pth")
    with pytest.raises(ValueError, match="fine network"):
        export(ckpt_dir, out)
    assert not os.path.exists(out)


@pytest.mark.parametrize("az,el,r", [(0.0, 0.3, 1.3), (1.7, 0.35, 1.3),
                                     (4.9, -0.2, 2.0), (np.pi, 1.2, 0.9)])
def test_orbit_pose_bit_equal(az, el, r):
    from tools.render_orbit import orbit_pose as j_orbit_pose

    got, want = orbit_pose(az, el, r), j_orbit_pose(az, el, r)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_estimate_radius_matches_jax():
    from tools.estimate_bound_radius import estimate_radius as j_estimate
    from codenerf_tpu_torch.estimate_bound_radius import estimate_radius

    cfg = {"net_hyperparams": NET, "N_samples": 16, "near": 0.8, "far": 1.8}
    jhp, hp = j_hparams_from_dict(cfg), hparams_from_dict(cfg)
    jparams = init_codenerf(jax.random.PRNGKey(0), jhp.net)
    # a dense enough density that some rays are opaque
    jparams["sigma"]["b"] = jnp.full_like(jparams["sigma"]["b"], 4.0)
    model = CodeNeRF(hp.net).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    codes = np.array(init_codes(jax.random.PRNGKey(1), 1, 32))[0]
    poses = np.stack([orbit_pose(a, 0.35, 1.3)
                      for a in np.linspace(0, 2 * np.pi, 4, endpoint=False)])
    want = j_estimate(jparams, jhp, poses, 17.6, 16, 16,
                      (jnp.asarray(codes), jnp.asarray(codes)))
    got = estimate_radius(model, hp, poses, 17.6, 16, 16,
                          (torch.from_numpy(codes), torch.from_numpy(codes)))
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= 1e-4, (got, want)


def _cli(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-m", module, *args],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_render_orbit_cli(tiny_run, tmp_path):
    from PIL import Image

    exps, run, jsonfile, _ = tiny_run
    out = str(tmp_path / "orbit")
    _cli("codenerf_tpu_torch.render_orbit", "--saved_dir", run, "--jsonfile",
         jsonfile, "--exps_root", exps, "--n_frames", "3", "--H", "12",
         "--W", "12", "--out", out, "--device", "cpu")
    frames = sorted(f for f in os.listdir(out) if f.startswith("frame_"))
    assert frames == ["frame_000.png", "frame_001.png", "frame_002.png"]
    assert np.asarray(Image.open(os.path.join(out, frames[0]))).shape == (
        12, 12, 3)
    with Image.open(os.path.join(out, "orbit.gif")) as gif:
        assert gif.n_frames == 3


def test_render_orbit_codes_npz(tiny_run, tmp_path):
    """``--codes`` renders an optimize run's codes: each frame is the
    direct render of the npz row at that orbit pose, clipped ×255."""
    from PIL import Image

    from codenerf_tpu_torch import render_orbit
    from codenerf_tpu_torch.renderer import render_image
    from codenerf_tpu_torch.utils.checkpoint import load_run

    exps, run, jsonfile, hp = tiny_run
    npz = str(tmp_path / "codes.npz")
    rng = np.random.default_rng(0)
    codes = rng.normal(size=(2, 2, 32)).astype(np.float32)
    np.savez(npz, optimized_shapecodes=codes[0],
             optimized_texturecodes=codes[1])
    out = render_orbit.main([
        "--saved_dir", run, "--jsonfile", jsonfile, "--exps_root", exps,
        "--n_frames", "2", "--H", "8", "--W", "8", "--device", "cpu",
        "--out", str(tmp_path / "b"), "--codes", npz, "--obj", "1"])
    model, fine, _, _ = load_run(os.path.join(exps, run), hp, "cpu")
    for i in range(2):
        img = render_image(model, hp.render, 8, 8, 8.8, torch.from_numpy(
            orbit_pose(np.pi * i, 0.3, 1.3)), torch.from_numpy(codes[0, 1]),
            torch.from_numpy(codes[1, 1]), None, chunk=64).numpy()
        want = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        got = np.asarray(Image.open(os.path.join(out, f"frame_{i:03d}.png")))
        np.testing.assert_array_equal(got, want)


def test_estimate_bound_radius_cli(tiny_run, tmp_path):
    """On a run directory holding only a ``models.pth`` whose density is
    high everywhere (so that rays are opaque)."""
    from codenerf_tpu_torch.config import NetConfig
    from codenerf_tpu_torch.utils.checkpoint import save_reference_checkpoint

    _, _, jsonfile, _ = tiny_run
    model = CodeNeRF(NetConfig(**NET),
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.sigma.bias.fill_(4.0)
    os.makedirs(tmp_path / "exps" / "dense")
    save_reference_checkpoint(str(tmp_path / "exps" / "dense" / "models.pth"),
                              model, torch.zeros(2, 32), torch.zeros(2, 32))
    out = _cli("codenerf_tpu_torch.estimate_bound_radius", "--saved_dir",
               "dense", "--jsonfile", jsonfile, "--exps_root",
               str(tmp_path / "exps"), "--H", "16", "--W", "16", "--device",
               "cpu")
    r = float(out.split("estimated bound_sphere_radius:")[1].split()[0])
    assert 0 < r < 3
