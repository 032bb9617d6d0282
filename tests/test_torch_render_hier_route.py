"""The hierarchical branch of ``renderer.render_rays_kernels``: NeRF's
coarse-to-fine sampling (64 coarse depths, 128 fine ones drawn from the
coarse weights, the fine network at the sorted union of 192) through the
sigma-only forward, the compositing weights, the resample, the fine
network's four-plane forward and the composite, here on CPU tensors,
where each kernel runs its plain version.

- against ``portbench/reference/hierarchical.py`` (float32, the
  published sampler) at the cars widths (W 256, 3 + 1 blocks, latent
  256, 10 / 4 frequencies) on 16 × 16 rays of an orbit view, with weights drawn as a
  served model's and the density layer times 16 (sharp enough that
  importance sampling matters; the benchmark's cell, judged over 64
  views, scales it by 64), shared and separate fine weights;
- the fp8 reference and a planted fault (``uniform_fine``: the fine
  depths drawn as if the coarse weights were uniform) fail the same bar;
- the plain module's hierarchical render at float32 against the
  reference;
- a coarse render given a separate fine network renders ``model``: the
  fine network has no pass to take;
- a random render draws its coarse depths and fine probes in the plain
  route's order;
- ``render_image.samples`` counts the points each forward evaluated, and
  ``RenderServer.timings()`` reports it.
"""

import math

import pytest
import torch

from codenerf_tpu_torch import renderer, serving
from codenerf_tpu_torch.config import NetConfig, RenderConfig
from codenerf_tpu_torch.core import sampling
from codenerf_tpu_torch.core.rays import camera_rays
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.render_orbit import orbit_pose
from portbench.reference import codenerf as ref
from portbench.reference import hierarchical

torch.set_num_threads(2)     # W=256 on the CPU: keep xdist workers apart

CAR = NetConfig(W=256, shape_blocks=3, texture_blocks=1, num_xyz_freq=10,
                num_dir_freq=4, latent_dim=256)
NET = {"W": 256, "shape_blocks": 3, "texture_blocks": 1, "num_xyz_freq": 10,
       "num_dir_freq": 4, "latent_dim": 256}
HP = {"net_hyperparams": NET, "N_samples": 64, "N_importance": 128,
      "near": 0.8, "far": 1.8}
DENSITY = 16.0     # the density layer's scale (see the module docstring)
BF16, F32 = torch.bfloat16, torch.float32
# The bar on the mean absolute rgb gap to the float32 reference. bf16
# rounding in both networks moves the coarse weights, hence the fine
# depths, and the colour at the sharp density layer: the kernel route
# reads 0.0008-0.0042 over eight seeds (seed 2, separate networks, the
# most; the bf16 plain module 0.0049 there), the fp8 reference 0.0078
# and more, the uniform_fine fault 0.0044-0.0103. No bar on the worst
# ray: at this density one ray in 256 may move by 0.1 as bf16 moves a
# fine depth across a thin shell (seed 2: 0.094), the fp8 reference's by
# 0.03-1.1.
MEAN_GAP = 0.005
# The kernel route no further from the reference than the bf16 plain
# module (its mean 0.83-0.98 of the plain module's over seeds 0-3).
PLAIN_RATIO = 1.1


def _served(seed: int):
    """A network as the served benchmark draws it: every layer's uniform
    range widened by sqrt(6), ``rgb_out`` centred on 0.5 with a spread
    of 0.25, the density layer times :data:`DENSITY`."""
    g = torch.Generator().manual_seed(seed)
    model = CodeNeRF(CAR, generator=g).requires_grad_(False)
    for name, lin in model.named_children():
        if name == "rgb_out":
            lin.weight.mul_(0.25 * math.sqrt(3.0))
            lin.bias.mul_(0.025 * math.sqrt(lin.weight.shape[1])).add_(0.5)
        else:
            lin.weight.mul_(math.sqrt(6.0))
            lin.bias.mul_(math.sqrt(6.0))
        if name == "sigma":
            lin.weight.mul_(DENSITY)
            lin.bias.mul_(DENSITY)
    return model


def _case(seed: int, shared: bool, H: int = 16):
    """``(coarse, fine, rcfg, rays, codes)`` of one seed: the fine network
    None when shared."""
    model = _served(seed)
    fine = None if shared else _served(100 + seed)
    g = torch.Generator().manual_seed(seed + 7)
    codes = torch.randn(2, CAR.latent_dim, generator=g) \
        / math.sqrt(CAR.latent_dim / 2.0)
    c2w = orbit_pose(0.7 + 2.1 * seed, 0.1 + 0.07 * seed, 1.3)
    rcfg = RenderConfig(n_samples=64, n_importance=128, near=0.8, far=1.8,
                        share_fine_weights=shared)
    return model, fine, rcfg, camera_rays(H, H, 1.1 * H, c2w), codes


def _reference(model, fine, rays, codes, precision="f32",
               uniform_fine=False):
    p = dict(model.state_dict())
    f = p if fine is None else dict(fine.state_dict())
    return hierarchical.render_rays(p, f, HP, *rays, codes[0], codes[1],
                              ref.Precision(precision), uniform_fine)


def _mean_gap(a, b) -> float:
    return float((a - b).abs().mean())


def _plain(model, fine, rcfg, rays, codes, dtype, chunk=128):
    ro, vd = rays
    with torch.no_grad():
        return torch.cat([renderer.render_rays(
            model, rcfg, ro[i:i + chunk], vd[i:i + chunk], codes[0],
            codes[1], None, compute_dtype=dtype, fine_model=fine).final.rgb
            for i in range(0, ro.shape[0], chunk)])


@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_route_against_reference(seed, shared):
    model, fine, rcfg, rays, codes = _case(seed, shared)
    got = renderer.render_rays_kernels(model, rcfg, *rays, codes[0],
                                       codes[1], None, None, 128, fine)
    want = _reference(model, fine, rays, codes)
    plain = _plain(model, fine, rcfg, rays, codes, BF16)
    assert got.shape == (256, 3) and got.dtype == F32
    k, p = _mean_gap(got, want), _mean_gap(plain, want)
    assert k <= MEAN_GAP and k <= PLAIN_RATIO * p, (k, p)


@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_fp8_fails_the_bar(shared):
    """The reference with fp8 products, one precision below the
    configuration's bf16, in the program's place: the bar refuses it."""
    model, fine, _, rays, codes = _case(0, shared)
    want = _reference(model, fine, rays, codes)
    got = _reference(model, fine, rays, codes, "fp8")
    assert _mean_gap(got, want) > MEAN_GAP


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_uniform_fine_fails(seed, monkeypatch):
    """The kernel route with its fine depths drawn as if the coarse
    weights were uniform fails the bar (the comparison shows whether
    importance sampling is done), as the reference's own
    ``uniform_fine`` does; the two agree within the bar."""
    model, fine, rcfg, rays, codes = _case(seed, False)
    want = _reference(model, fine, rays, codes)
    uniform = _reference(model, fine, rays, codes, uniform_fine=True)
    monkeypatch.setattr(renderer, "composite_weights",
                        lambda sig, z: torch.ones_like(sig))
    got = renderer.render_rays_kernels(model, rcfg, *rays, codes[0],
                                       codes[1], None, None, 128, fine)
    assert _mean_gap(got, want) > MEAN_GAP
    assert _mean_gap(uniform, want) > MEAN_GAP
    assert _mean_gap(got, uniform) <= MEAN_GAP


@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_plain_route_against_reference(shared):
    """The plain module at float32, its fine pass through ``render_rays``
    (shared weights: the new depths alone, merged with the coarse ones):
    the reference's math to float32 rounding, which the fine depths
    carry through the sort (worst 1e-4)."""
    model, fine, rcfg, rays, codes = _case(1, shared)
    got = _plain(model, fine, rcfg, rays, codes, F32)
    want = _reference(model, fine, rays, codes)
    assert float((got - want).abs().max()) <= 1e-4


def test_coarse_render_ignores_the_fine_network():
    """At ``n_importance`` 0 a separate fine network, given and not
    shared, has no pass to take: the kernel route renders ``model``, bit
    for bit as when no fine network is given, and as close to the float32
    plain module on ``model`` as the bf16 plain module is."""
    model, fine, _, rays, codes = _case(4, False)
    rcfg = RenderConfig(n_samples=64, near=0.8, far=1.8,
                        share_fine_weights=False)
    got = renderer.render_rays_kernels(model, rcfg, *rays, codes[0],
                                       codes[1], None, None, 128, fine)
    alone = renderer.render_rays_kernels(model, rcfg, *rays, codes[0],
                                         codes[1], None, None, 128)
    assert torch.equal(got, alone)
    want = _plain(model, None, rcfg, rays, codes, F32)
    plain = _plain(model, fine, rcfg, rays, codes, BF16)
    other = _plain(fine, None, rcfg, rays, codes, F32)
    k, p = _mean_gap(got, want), _mean_gap(plain, want)
    assert k <= PLAIN_RATIO * p, (k, p)
    assert _mean_gap(got, other) > 10 * k


def test_random_draws_in_plain_order(monkeypatch):
    """With a generator the kernel route draws each chunk's coarse
    jitter, then its fine probes, as ``render_rays`` does chunk by chunk:
    the same numbers reach the depths and ``sample_pdf``."""
    model, fine, rcfg, rays, codes = _case(5, False, H=8)
    rcfg = RenderConfig(n_samples=64, n_importance=128,
                        share_fine_weights=False, bound_sphere_radius=0.6)
    seen = {"plain": [], "kernels": []}
    probe = sampling.sample_pdf

    def spy(bins, weights, n, generator=None, deterministic=False, u=None):
        if u is None:
            u = sampling.fine_uniforms(generator, bins.shape[0], n)
        seen[route].append((bins.clone(), u.clone()))
        return probe(bins, weights, n, generator, deterministic, u)

    monkeypatch.setattr(renderer, "sample_pdf", spy)
    route = "kernels"
    renderer.render_rays_kernels(model, rcfg, *rays, codes[0], codes[1],
                                 torch.Generator().manual_seed(9), None, 32,
                                 fine)
    route = "plain"
    gen = torch.Generator().manual_seed(9)
    ro, vd = rays
    with torch.no_grad():
        for i in range(0, 64, 32):
            renderer.render_rays(model, rcfg, ro[i:i + 32], vd[i:i + 32],
                                 codes[0], codes[1], gen, fine_model=fine)
    (kb, ku), = seen["kernels"]
    assert torch.equal(kb, torch.cat([b for b, _ in seen["plain"]]))
    assert torch.equal(ku, torch.cat([u for _, u in seen["plain"]]))


@pytest.mark.parametrize("hier", [True, False], ids=["hierarchical",
                                                     "coarse"])
def test_samples_counted(hier, monkeypatch):
    """``render_image.samples``: the coarse points through the sigma-only
    forward and the points through the four-plane forward (the union on a
    hierarchical render), padded rays included; ``timings()`` reports
    them."""
    model, fine, rcfg, _, codes = _case(6, not hier, H=6)
    rcfg = RenderConfig(n_samples=8, n_importance=16 if hier else 0,
                        share_fine_weights=False)
    monkeypatch.setattr(renderer, "kernel_route", lambda *a, **k: True)
    hp = type("Hp", (), {"render": rcfg, "compute_dtype": "bfloat16"})()
    server = serving.RenderServer({"model": model, "fine_model": fine,
                                   "shape_codes": codes[:1],
                                   "texture_codes": codes[1:]}, hp)
    try:
        before = server.timings()["samples"]
        server.render({"obj": 0, "H": 12, "W": 12})
        after = server.timings()["samples"]
    finally:
        server.shutdown()
    n_padded = renderer.chunk_plan(144, 4096)[2]
    assert {k: after[k] - before[k] for k in after} == {
        "coarse_sigma": n_padded * 8 if hier else 0,
        "planes": n_padded * (24 if hier else 8)}


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel route runs only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_hier_render_image_on_the_card(card, shared):
    """128 × 128 hierarchical renders (64 + 128) through the kernels, held
    with the bf16 plain module to the float32 plain module on the same
    rays, as ``tests/test_torch_render_route.py`` holds the coarse route:
    the kernel route's mean gap within 1.1 times the bf16 module's and
    its worst pixel within a level of the bf16 module's worst. One
    sigma-only forward, one four-plane forward at 192 and one composite
    a view; every chunk counted as ``kernels``."""
    from codenerf_tpu_torch.ops import composite, fused_mlp

    model, fine, rcfg, _, codes = _case(7, shared)
    model = model.to(card)
    fine = None if fine is None else fine.to(card)
    s, t = codes[0].to(card), codes[1].to(card)
    chunk, n_chunks, _ = renderer.chunk_plan(128 * 128, 4096)
    assert renderer.kernel_route(model, rcfg, chunk, BF16, card, fine)
    chunks0 = dict(renderer.render_image.chunks)
    launches0 = (fused_mlp.sigma_fwd.launches["sigma"],
                 fused_mlp.planes_fwd.launches["planes"],
                 composite.launches["composite"])
    for seed in range(2):
        c2w = orbit_pose(0.7 + 2.1 * seed, 0.1 + 0.2 * seed, 1.3)
        img = renderer.render_image(model, rcfg, 128, 128, 140.8, c2w, s, t,
                                    fine_model=fine).reshape(-1, 3)
        rays = camera_rays(128, 128, 140.8, c2w, device=card)
        plain = {dt: _plain(model, fine, rcfg, rays, (s, t), dt, chunk)
                 for dt in (BF16, F32)}
        k = (img - plain[F32]).abs()
        p = (plain[BF16] - plain[F32]).abs()
        assert float(k.mean()) <= PLAIN_RATIO * float(p.mean()), seed
        assert float(k.max()) <= float(p.max()) + 1.0 / 255.0, seed
    launches = (fused_mlp.sigma_fwd.launches["sigma"],
                fused_mlp.planes_fwd.launches["planes"],
                composite.launches["composite"])
    assert [b - a for a, b in zip(launches0, launches)] == [2, 2, 2]
    chunks = renderer.render_image.chunks
    assert chunks["kernels"] - chunks0["kernels"] == 2 * n_chunks
    assert chunks["plain"] == chunks0["plain"]
