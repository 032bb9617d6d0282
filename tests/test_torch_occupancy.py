"""The port's occupancy grid and per-ray sampling bounds against the JAX
package, on the same seeded inputs.

Tolerances, each with its reason:

- ``dilate_grid``, ``grid_from_density``, ``full_grid``,
  ``occupancy_at``, ``ray_grid_bounds``, ``ray_sphere_bounds`` and the
  per-ray ``stratified_zvals`` (with the JAX package's own jitter bytes):
  exact. Both compute the same f32 operations in the same order, and the
  ``[0, 1]`` linspace of the probes and the bounded depths is built bit
  for bit as ``jnp.linspace`` builds it (``core/sampling.lerp_linspace``);
- linspaces over other ranges (the grid's cell edges, the deterministic
  CDF probes ``[0, 1 - 1e-5]``): within two f32 ulps of the larger end,
  since XLA's CPU division rounds some lanes of ``iota / (n - 1)``
  differently from an IEEE division;
- ``eval_sigma_grid`` and the category densities (plain ``CodeNeRF``
  forward in bf16 on both sides, rounded at different points by XLA and
  PyTorch): within 2e-2 relative plus 1e-3 absolute per cell (bf16 keeps
  8 bits, ~3.9e-3 relative per rounding, over a few roundings);
- the grids thresholded from those densities: equal in every cell whose
  density lies more than that bar from the threshold (cells nearer to it
  may fall either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.config import TrainOccupancyConfig as JOccConfig
from codenerf_tpu.core import occupancy as j_occ
from codenerf_tpu.core import rays as j_rays
from codenerf_tpu.core import sampling as j_sampling
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu_torch.config import NetConfig, TrainOccupancyConfig
from codenerf_tpu_torch.core import occupancy as occ
from codenerf_tpu_torch.core import rays, sampling
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax

NET = dict(shape_blocks=2, texture_blocks=1, W=64, num_xyz_freq=6,
           num_dir_freq=2, latent_dim=16)
G = 12
RADIUS = 1.4


def _grid_pair(seed=0, p=0.1):
    rng = np.random.default_rng(seed)
    occ_np = rng.uniform(size=(G, G, G)) < p
    return (j_occ.OccupancyGrid(occ=jnp.asarray(occ_np),
                                radius=jnp.asarray(RADIUS, jnp.float32)),
            occ.OccupancyGrid(torch.from_numpy(occ_np), RADIUS), occ_np)


def _rays(n=256, seed=1):
    """Rays from a sphere of radius 1.3-1.6 towards the origin's
    neighbourhood, some missing the bounding sphere."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    ro = (d / np.linalg.norm(d, axis=-1, keepdims=True)
          * rng.uniform(1.3, 1.6, (n, 1))).astype(np.float32)
    target = rng.uniform(-1.6, 1.6, (n, 3))
    vd = target - ro
    vd = (vd / np.linalg.norm(vd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, vd


def test_cell_centers_and_full_grid_exact():
    got = occ.grid_cell_centers(G, RADIUS).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_occ.grid_cell_centers(G, RADIUS)), rtol=0,
        atol=np.spacing(np.float32(RADIUS)))
    full = occ.full_grid(G, RADIUS)
    assert full.occ.dtype == torch.bool and bool(full.occ.all())
    assert full.occ.shape == (G, G, G) and full.radius == RADIUS


@pytest.mark.parametrize("iterations", [1, 2])
def test_dilate_grid_exact(iterations):
    _, _, occ_np = _grid_pair(p=0.02)
    want = np.asarray(j_occ.dilate_grid(jnp.asarray(occ_np), iterations))
    got = occ.dilate_grid(torch.from_numpy(occ_np), iterations).numpy()
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask_radius", [None, 1.2])
@pytest.mark.parametrize("dilate", [0, 1])
def test_grid_from_density_exact(mask_radius, dilate):
    rng = np.random.default_rng(4)
    density = (rng.exponential(0.02, (G, G, G))).astype(np.float32)
    want = j_occ.grid_from_density(jnp.asarray(density), RADIUS,
                                   sigma_threshold=0.03, dilate=dilate,
                                   mask_radius=mask_radius)
    got = occ.grid_from_density(torch.from_numpy(density), RADIUS,
                                sigma_threshold=0.03, dilate=dilate,
                                mask_radius=mask_radius)
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    assert np.float32(got.radius) == np.asarray(want.radius)


def test_occupancy_at_exact():
    jgrid, tgrid, _ = _grid_pair(seed=2, p=0.4)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.6, 1.6, (40, 7, 3)).astype(np.float32)
    pts[0, 0] = [RADIUS, RADIUS, RADIUS]          # the box's far corner
    pts[0, 1] = [-RADIUS, 0.0, 0.0]
    want = np.asarray(j_occ.occupancy_at(jgrid, jnp.asarray(pts)))
    got = occ.occupancy_at(tgrid, torch.from_numpy(pts)).numpy()
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_probes", [16, 33])
def test_ray_bounds_exact(n_probes):
    """Sphere bounds (misses included), then the grid's tightening (rays
    with no occupied probe included)."""
    ro, vd = _rays()
    jgrid, tgrid, _ = _grid_pair(seed=5, p=0.05)
    jt0, jt1 = j_rays.ray_sphere_bounds(jnp.asarray(ro), jnp.asarray(vd),
                                        0.8, 1.8, RADIUS)
    t0, t1 = rays.ray_sphere_bounds(torch.from_numpy(ro),
                                    torch.from_numpy(vd), 0.8, 1.8, RADIUS)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jt1))
    hit = (t1 - t0).numpy() > 1.5e-3
    assert hit.any() and not hit.all()
    jg0, jg1 = j_occ.ray_grid_bounds(jgrid, jnp.asarray(ro), jnp.asarray(vd),
                                     jt0, jt1, n_probes=n_probes)
    g0, g1 = occ.ray_grid_bounds(tgrid, torch.from_numpy(ro),
                                 torch.from_numpy(vd), t0, t1,
                                 n_probes=n_probes)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(jg0))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(jg1))
    tightened = (g0 > t0) | (g1 < t1)
    assert bool(tightened.any())


def test_per_ray_stratified_zvals_exact():
    """Per-ray (R,) bounds with the JAX package's own jitter bytes."""
    ro, vd = _rays(64, seed=6)
    t0, t1 = rays.ray_sphere_bounds(torch.from_numpy(ro),
                                    torch.from_numpy(vd), 0.8, 1.8, RADIUS)
    key = jax.random.PRNGKey(7)
    n = 24
    want = j_sampling.stratified_zvals(key, jnp.asarray(t0.numpy()),
                                       jnp.asarray(t1.numpy()), n,
                                       num_rays=64)
    jitter = np.array(j_sampling._uniform01_u8(key, 64, n))
    got = sampling.stratified_zvals(None, t0, t1, n, num_rays=64,
                                    jitter=torch.from_numpy(jitter))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="per-ray"):
        sampling.stratified_zvals(None, t0, t1, n, num_rays=64, shared=True)


@pytest.mark.parametrize("n", [1, 2, 16, 17, 33, 64])
def test_lerp_linspace_matches_jnp_linspace(n):
    for a, b in ((0.0, 1.0), (0.0, 1.0 - 1e-5), (-RADIUS, RADIUS)):
        got = sampling.lerp_linspace(a, b, n).numpy()
        want = np.asarray(jnp.linspace(a, b, n, dtype=jnp.float32))
        if (a, b) == (0.0, 1.0):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 * np.spacing(np.float32(b)))


def _models(n_objects=3):
    """Seeded weights in both packages, the sigma head scaled up so that
    the density varies over the box (at the plain init it sits near
    softplus(0) everywhere)."""
    jcfg = JNetConfig(**NET)
    jparams = init_codenerf(jax.random.PRNGKey(0), jcfg)
    jparams["sigma"] = {"w": jparams["sigma"]["w"] * 40.0,
                        "b": jparams["sigma"]["b"] - 2.0}
    sc = np.asarray(init_codes(jax.random.PRNGKey(1), n_objects, 16)) * 3
    tc = np.asarray(init_codes(jax.random.PRNGKey(2), n_objects, 16))
    model = CodeNeRF(NetConfig(**NET))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    return jcfg, jparams, model.requires_grad_(False), sc, tc


BAR = dict(rtol=2e-2, atol=1e-3)


def _grids_agree(got, want, density, threshold):
    """Equal wherever the density is clear of the threshold by the bar
    (the grids here are undilated, so a cell's state is its own)."""
    clear = np.abs(density - threshold) > (BAR["rtol"] * np.abs(density)
                                           + BAR["atol"])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])


def test_eval_sigma_grid_and_build_within_bf16():
    jcfg, jparams, model, sc, tc = _models()
    want = np.asarray(j_occ.eval_sigma_grid(jparams, jcfg, jnp.asarray(sc[0]),
                                            jnp.asarray(tc[0]), G, RADIUS))
    got = occ.eval_sigma_grid(model, torch.from_numpy(sc[0]),
                              torch.from_numpy(tc[0]), G, RADIUS).numpy()
    assert got.shape == (G, G, G) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **BAR)
    thr = float(np.median(want))
    jg = j_occ.build_occupancy_grid(jparams, jcfg, jnp.asarray(sc[0]),
                                    jnp.asarray(tc[0]), G=G, radius=RADIUS,
                                    sigma_threshold=thr, dilate=0)
    tg = occ.build_occupancy_grid(model, torch.from_numpy(sc[0]),
                                  torch.from_numpy(tc[0]), G=G, radius=RADIUS,
                                  sigma_threshold=thr, dilate=0)
    _grids_agree(tg.occ.numpy(), np.asarray(jg.occ), want, thr)


def test_update_density_grid_and_category_scan_within_bf16():
    """The EMA refresh from two codes, and the full-category scan in
    chunks of 2 over 3 objects (the wrap-around chunk included)."""
    jcfg, jparams, model, sc, tc = _models()
    rng = np.random.default_rng(8)
    d0 = rng.uniform(0.0, 2.0, (G, G, G)).astype(np.float32)
    want = np.asarray(j_occ.update_density_grid(
        jnp.asarray(d0), jparams, jcfg, jnp.asarray(sc[:2]),
        jnp.asarray(tc[:2]), RADIUS, decay=0.9))
    got = occ.update_density_grid(
        torch.from_numpy(d0), model, torch.from_numpy(sc[:2]),
        torch.from_numpy(tc[:2]), RADIUS, decay=0.9).numpy()
    np.testing.assert_allclose(got, want, **BAR)

    trainables = {"params": jparams, "shape_codes": jnp.asarray(sc),
                  "texture_codes": jnp.asarray(tc)}
    jd, _ = j_occ.category_density_scan(trainables, jcfg, G, RADIUS, 2)
    jd = np.asarray(jd)
    thr = float(np.median(jd))
    _, jgrid = j_occ.category_density_scan(trainables, jcfg, G, RADIUS, 2,
                                           sigma_threshold=thr, dilate=0)
    td, tgrid = occ.category_density_scan(
        model, torch.from_numpy(sc), torch.from_numpy(tc), G, RADIUS, 2,
        sigma_threshold=thr, dilate=0)
    np.testing.assert_allclose(td.numpy(), jd, **BAR)
    _grids_agree(tgrid.occ.numpy(), np.asarray(jgrid.occ), jd, thr)
    # Order- and chunk-independent: a max-union, bit for bit.
    td3, _ = occ.category_density_scan(
        model, torch.from_numpy(sc), torch.from_numpy(tc), G, RADIUS, 3)
    np.testing.assert_array_equal(td3.numpy(), td.numpy())

    ocfg = dict(grid_size=G, codes_per_update=2, sigma_threshold=thr,
                dilate=0, radius=RADIUS)
    jr = j_occ.rebuild_category_grid(trainables, jcfg, JOccConfig(**ocfg),
                                     RADIUS)
    tr = occ.rebuild_category_grid(model, torch.from_numpy(sc),
                                   torch.from_numpy(tc),
                                   TrainOccupancyConfig(**ocfg), RADIUS)
    _grids_agree(tr.occ.numpy(), np.asarray(jr.occ), jd, thr)


@pytest.mark.parametrize("n_objects", [1, 5, 37, 2458])
@pytest.mark.parametrize("cfg", [
    {}, {"codes_per_update": 4}, {"decay": 1.0}, {"decay": 0.95}])
def test_resolve_codes_per_update_matches_jax(n_objects, cfg):
    assert occ.resolve_codes_per_update(TrainOccupancyConfig(**cfg),
                                        n_objects) == \
        j_occ.resolve_codes_per_update(JOccConfig(**cfg), n_objects)
