"""Core math of the PyTorch port against its JAX twins on shared seeded
inputs: positional encoding, camera rays, z sampling, compositing and the
eval metrics. All float32; the bar is 1e-5 (both sides compute the same
f32 expressions, differing only in transcendental and summation ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.core import encoding as j_enc
from codenerf_tpu.core import rays as j_rays
from codenerf_tpu.core import render as j_render
from codenerf_tpu.core import sampling as j_sampling
from codenerf_tpu.evaluation import metrics as j_metrics
from codenerf_tpu_torch.core import encoding, rays, render, sampling
from codenerf_tpu_torch.evaluation import metrics

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_positional_encoding(num_freqs):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (5, 7, 3)).astype(
        np.float32)
    got = encoding.positional_encoding(torch.from_numpy(x), num_freqs)
    want = j_enc.positional_encoding(jnp.asarray(x), num_freqs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_camera_rays():
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3], c2w[:3, 3] = q, rng.normal(size=3)
    ro, vd = rays.camera_rays(6, 8, 7.5, c2w)
    jro, jvd = j_rays.camera_rays(6, 8, 7.5, jnp.asarray(c2w))
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), **TOL)
    np.testing.assert_allclose(vd.numpy(), np.asarray(jvd), **TOL)


def test_fixed_and_stratified_zvals(monkeypatch):
    np.testing.assert_allclose(sampling.fixed_zvals(0.8, 1.8, 96).numpy(),
                               np.asarray(j_sampling.fixed_zvals(0.8, 1.8,
                                                                 96)), **TOL)
    R, N = 9, 24
    jitter = (np.random.default_rng(2).integers(0, 256, (R, N))
              / 256.0).astype(np.float32)
    monkeypatch.setattr(j_sampling, "_uniform01_u8",
                        lambda key, r, n: jnp.asarray(jitter))
    want = j_sampling.stratified_zvals(None, 0.8, 1.8, N, num_rays=R)
    got = sampling.stratified_zvals(None, 0.8, 1.8, N, num_rays=R,
                                    jitter=torch.from_numpy(jitter))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    gen = torch.Generator().manual_seed(0)
    u = sampling.uniform01_u8(gen, R, N)
    assert u.shape == (R, N) and float(u.min()) >= 0 and float(u.max()) < 1
    np.testing.assert_array_equal((u * 256).numpy(),
                                  np.round((u * 256).numpy()))
    z = sampling.stratified_zvals(gen, 0.8, 1.8, N, num_rays=R)
    assert z.shape == (R, N) and bool((z[:, 1:] > z[:, :-1]).all())


@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("form", ["array", "planes", "shared_z"])
def test_composite(white_bg, form):
    rng = np.random.default_rng(3)
    R, S = 11, 16
    sig = rng.uniform(0.0, 8.0, (R, S)).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (R, S, 3)).astype(np.float32)
    z = np.sort(rng.uniform(0.8, 1.8, (R, S)), -1).astype(np.float32)
    if form == "shared_z":
        z = z[0]
    if form == "planes":
        t_rgb = tuple(torch.from_numpy(rgb[..., k]) for k in range(3))
        j_rgb = tuple(jnp.asarray(rgb[..., k]) for k in range(3))
    else:
        t_rgb, j_rgb = torch.from_numpy(rgb), jnp.asarray(rgb)
    got = render.composite(torch.from_numpy(sig), t_rgb, torch.from_numpy(z),
                           white_bg=white_bg)
    want = j_render.composite(jnp.asarray(sig), j_rgb, jnp.asarray(z),
                              white_bg=white_bg)
    for name in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("data_range", [2.0, 1.0])
def test_psnr_and_ssim(data_range):
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (20, 17, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    mse = metrics.reference_psnr_mse(ta, tb)
    jmse = j_metrics.reference_psnr_mse(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-5)
    np.testing.assert_allclose(float(metrics.psnr(mse)),
                               float(j_metrics.psnr(jmse)), rtol=1e-5)
    np.testing.assert_allclose(
        float(metrics.ssim(ta, tb, data_range=data_range)),
        float(j_metrics.ssim(jnp.asarray(a), jnp.asarray(b),
                             data_range=data_range)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(metrics.ssim(ta[..., 0], tb[..., 0])),
        float(j_metrics.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0]))),
        rtol=1e-5, atol=1e-6)
