"""The port's device scene renderers (``codenerf_tpu_torch/data/
synthetic.py``: ``make_view_fn``, ``make_gt_view_renderer``,
``_render_pairs``, ``synthetic_scene(backend="device")``) and what they
feed (``CodeOptimizer.evaluate_objects(gt_params=...)``, ``quality_report
--scene_backend device --device_gt``), on the CPU (``device="cpu"``).

- ``make_view_fn`` against the JAX package's (``jax.jit`` of its ``vmap``)
  on the same seeded cameras and parameters, spheres and chairs, pattern
  on and off: at least 99.9% of the f32 pixels within 1e-5, the
  quantized pixels at most one level apart on under 0.5% of them.
- ``synthetic_scene(backend="device")`` against the port's numpy path and
  the JAX package's ``backend="jax"``: poses, focals, near/far and the
  generation parameters bit-equal; the pixels within JAX's own bar of its
  device path (``tests/test_data.py:268-271``): one level at most, under
  0.5% of pixels.
- ``_render_pairs`` at a pair count that is no multiple of the inner
  batch or of the chunk: the same bytes as in one chunk, and the numpy
  bar against ``numpy_pairs`` (the numpy path's bytes of chosen pairs).
- Eval on device-rendered ground truth against the pixel path on the
  same codes and generators, both geometries, the scene rendered by
  either backend: PSNR within 0.02 dB and SSIM within 1e-3 (the JAX
  package's bar, ``tests/test_optimization.py:557-558``), the same views.
- The quality report with ``--scene_backend device --device_gt
  --opt_group 2`` against ``--scene_backend device --opt_group 2`` on one
  trained checkpoint: the same fits, eval within the same bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.data import synthetic as j_syn
from codenerf_tpu_torch import quality_report as t_tool
from codenerf_tpu_torch.config import Hparams, NetConfig, RenderConfig
from codenerf_tpu_torch.data import synthetic as t_syn
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quantized_bar(got: np.ndarray, want: np.ndarray) -> None:
    """uint8 images: at most one level apart, on under 0.5% of pixels."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 5e-3, (d > 0).mean()


def _leaves(scene: dict, geometry: str) -> dict:
    if geometry == "chair":
        return dict(albedo=scene["albedos"], boxes=scene["boxes"],
                    yaw=scene["yaws"])
    return dict(albedo=scene["albedos"], radius=scene["radii"])


@pytest.mark.parametrize("geometry", ["sphere", "chair"])
@pytest.mark.parametrize("pattern", [False, True])
def test_view_fn_matches_jax(geometry, pattern):
    H, W = 24, 20
    sc = j_syn.synthetic_scene(n_objects=3, n_views=4, H=H, W=W, seed=5,
                               geometry=geometry, params_only=True)
    obj = np.repeat(np.arange(3), 4)
    view = np.tile(np.arange(4), 3)
    c2w = sc["poses"][obj, view]
    focal = np.float32(sc["focals"][0])
    leaves = {k: np.asarray(v, np.float32)[obj]
              for k, v in _leaves(sc, geometry).items()}
    geom = [leaves[k] for k in leaves if k != "albedo"]

    j_fn = j_syn.make_view_fn(H, W, pattern, geometry)
    want = np.asarray(jax.jit(jax.vmap(j_fn, in_axes=(0, None, 0) + (0,) *
                                       len(geom)))(
        jnp.asarray(c2w), jnp.float32(focal), jnp.asarray(leaves["albedo"]),
        *map(jnp.asarray, geom)))
    t_fn = t_syn.make_view_fn(H, W, pattern, geometry, device="cpu")
    got = t_fn(torch.from_numpy(c2w), torch.tensor(focal),
               torch.from_numpy(leaves["albedo"]),
               *map(torch.from_numpy, geom)).numpy()
    assert got.shape == want.shape == (12, H * W, 3)
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.999
    _quantized_bar(np.round(got * 255), np.round(want * 255))
    assert (got < 1.0).any(axis=-1).mean() > 0.05   # objects, not background
    # One view without the pair axis.
    one = t_fn(torch.from_numpy(c2w[5]), torch.tensor(focal),
               torch.from_numpy(leaves["albedo"][5]),
               *(torch.as_tensor(g[5]) for g in geom)).numpy()
    assert one.shape == (H * W, 3)
    np.testing.assert_allclose(one, got[5], atol=1e-6)


@pytest.mark.parametrize("geometry", ["sphere", "chair"])
@pytest.mark.parametrize("pattern", [False, True])
def test_device_scene_matches_numpy(geometry, pattern):
    kw = dict(n_objects=3, n_views=5, H=40, W=32, seed=7, pattern=pattern,
              geometry=geometry)
    want = t_syn.synthetic_scene(**kw)
    got = t_syn.synthetic_scene(backend="device", device="cpu", **kw)
    assert list(got) == list(want)
    for k, w in want.items():
        if k == "images":
            assert got[k].dtype == np.uint8 and got[k].shape == w.shape
            _quantized_bar(got[k], w)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k
    _quantized_bar(got["images"],
                   j_syn.synthetic_scene(backend="jax", **kw)["images"])
    assert (got["images"] < 255).mean() > 0.05


def test_render_pairs_chunk_edges():
    """150 pairs at 160×250 (an inner batch of 104 pairs) in chunks of
    120: chunk [0, 120) splits at 104, chunk [120, 150) is short."""
    H, W, n_obj, n_views = 160, 250, 10, 15
    kw = dict(n_objects=n_obj, n_views=n_views, H=H, W=W, seed=2,
              pattern=True)
    d = t_syn._draws(n_obj, n_views, W, None, 4.0, 2, "sphere")
    c2w, albedo, geom = t_syn._pair_operands(d, n_obj, n_views, "sphere")
    args = (H, W, d["focal"], c2w, albedo, True, "sphere")
    assert max(16, min(256, (1 << 22) // (H * W))) == 104
    got = t_syn._render_pairs(*args, chunk_pairs=120, device="cpu", **geom)
    whole = t_syn._render_pairs(*args, chunk_pairs=150, device="cpu", **geom)
    assert got.shape == (150, H, W, 3)
    np.testing.assert_array_equal(got, whole)
    pairs = [(o, v) for o in range(n_obj) for v in range(n_views)]
    _quantized_bar(got, t_syn.numpy_pairs(pairs, **kw))


def test_numpy_pairs_are_the_numpy_scene():
    kw = dict(n_objects=4, n_views=3, H=16, W=24, seed=8, pattern=True,
              geometry="chair")
    scene = t_syn.synthetic_scene(**kw)
    pairs = [(3, 1), (0, 2), (3, 1), (1, 0)]
    np.testing.assert_array_equal(
        t_syn.numpy_pairs(pairs, **kw),
        scene["images"][[p[0] for p in pairs], [p[1] for p in pairs]])


@pytest.mark.parametrize("geometry", ["sphere", "chair"])
def test_gt_view_renderer(geometry):
    """One object's leaves: the JAX renderer's values within a level and
    the device scene's bytes, quantized as they are."""
    H, W = 24, 24
    kw = dict(n_objects=2, n_views=3, H=H, W=W, seed=4, pattern=True,
              geometry=geometry)
    scene = t_syn.synthetic_scene(backend="device", device="cpu", **kw)
    leaves = {k: np.asarray(v, np.float32)
              for k, v in _leaves(scene, geometry).items()}
    j_gt = jax.jit(j_syn.make_gt_view_renderer(H, W, True, geometry))
    t_gt = t_syn.make_gt_view_renderer(H, W, True, geometry, device="cpu")
    for o in range(2):
        for v in range(3):
            got = t_gt(torch.from_numpy(scene["poses"][o, v]),
                       torch.tensor(scene["focals"][o]),
                       {k: torch.as_tensor(x[o]) for k, x in
                        leaves.items()}).numpy()
            want = np.asarray(j_gt(scene["poses"][o, v], scene["focals"][o],
                                   {k: x[o] for k, x in leaves.items()}))
            assert got.shape == (H, W, 3)
            np.testing.assert_array_equal(got * 255, np.round(got * 255))
            _quantized_bar(np.round(got * 255), np.round(want * 255))
            _quantized_bar(np.round(got * 255), scene["images"][o, v])


def _optimizer():
    torch.manual_seed(0)
    net = NetConfig(shape_blocks=2, texture_blocks=1, W=64, num_xyz_freq=6,
                    num_dir_freq=2, latent_dim=16)
    hp = Hparams(net=net, render=RenderConfig(n_samples=16, near=2.2,
                                              far=5.8))
    model = CodeNeRF(net)
    opt = CodeOptimizer(model, hp, torch.zeros(16), torch.zeros(16),
                        device="cpu")
    return opt, torch.randn(2, 16) * 0.3, torch.randn(2, 16) * 0.3


@pytest.mark.parametrize("geometry", ["sphere", "chair"])
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_evaluate_objects_device_gt(geometry, backend):
    opt, s, t = _optimizer()
    kw = dict(n_objects=2, n_views=4, H=16, W=16, seed=3, pattern=True,
              geometry=geometry, backend=backend)
    sc = t_syn.synthetic_scene(device="cpu", **kw)

    def gens():
        return [torch.Generator().manual_seed(11 + g) for g in range(2)]

    ev_px = opt.evaluate_objects(sc["images"], sc["poses"], sc["focals"],
                                 [0], s, t, gens(), return_images=True)
    gt_params = dict(geometry=geometry, pattern=True, hw=(16, 16),
                     **_leaves(sc, geometry))
    ev_dev = opt.evaluate_objects(None, sc["poses"], sc["focals"], [0], s, t,
                                  gens(), return_images=True,
                                  gt_params=gt_params)
    np.testing.assert_array_equal(ev_px["views"], ev_dev["views"])
    np.testing.assert_array_equal(ev_px["views"], [1, 2, 3])
    assert ev_dev["psnr"].shape == ev_dev["ssim"].shape == (2, 3)
    assert np.isfinite(ev_dev["psnr"]).all()
    np.testing.assert_allclose(ev_dev["psnr"], ev_px["psnr"], atol=0.02)
    np.testing.assert_allclose(ev_dev["ssim"], ev_px["ssim"], atol=1e-3)
    # The same renders: only the ground truth's source differs.
    np.testing.assert_array_equal(ev_dev["images"], ev_px["images"])


NET = NetConfig(shape_blocks=2, texture_blocks=1, W=64, num_xyz_freq=6,
                num_dir_freq=2, latent_dim=32)
ARGV = ["--steps", "6", "--num_opts", "4", "--n_train_objects", "2",
        "--n_test_objects", "2", "--n_views", "4", "--size", "16",
        "--samples", "16", "--seeds", "0", "--opt_group", "2",
        "--scene_backend", "device", "--device", "cpu",
        "--geometry", "chair", "--save_images", "1"]


def test_quality_report_device_gt(tmp_path):
    """``--scene_backend device`` trains and fits on device-rendered
    scenes; ``--device_gt`` reruns the checkpoint's fits (the same) and
    scores them on ground truth rendered from the parameters."""
    parse = t_tool.build_parser().parse_args
    out = str(tmp_path)
    a = t_tool.run_once(parse(ARGV + ["--out", out]), 0, out, net=NET,
                        batch_size=256)
    b = t_tool.run_once(parse(ARGV + ["--out", out, "--resume_train",
                                      "--device_gt"]), 0, out, net=NET,
                        batch_size=256)
    assert len(a["rows"]) == len(b["rows"]) == 2
    for ra, rb in zip(a["rows"], b["rows"]):
        assert ra[0] == rb[0]
        assert ra[3:] == rb[3:]                       # the same fits
        assert abs(ra[1] - rb[1]) <= 0.02 and abs(ra[2] - rb[2]) <= 1e-3
    for (sa, ta), (sb, tb) in zip(a["codes"], b["codes"]):
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(ta, tb)
    assert len(b["eval_s"]) == 2 and (tmp_path / "heldout_0.png").exists()


def test_cache_keys_device_entries_apart(tmp_path):
    """A device entry is keyed by its backend and device, apart from the
    numpy entry of the same scene, and loads back as it was rendered."""
    kw = dict(n_objects=2, n_views=3, H=16, W=16, seed=6, pattern=True,
              geometry="chair")
    numpy_scene = t_syn.synthetic_scene_cached(str(tmp_path), **kw)
    dev = t_syn.synthetic_scene_cached(str(tmp_path), backend="device",
                                       device="cpu", **kw)
    entries = sorted(p.name for p in tmp_path.iterdir())
    assert len(entries) == 2 and "backend-device" in entries[0] + entries[1]
    again = t_syn.synthetic_scene_cached(str(tmp_path), backend="device",
                                         device="cpu", **kw)
    np.testing.assert_array_equal(again["images"], dev["images"])
    np.testing.assert_array_equal(
        dev["images"], t_syn.synthetic_scene(backend="device", device="cpu",
                                             **kw)["images"])
    _quantized_bar(dev["images"], numpy_scene["images"])
