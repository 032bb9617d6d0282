"""The two routes of ``renderer.render_image``: the forward kernels
(``renderer.render_rays_kernels``: ``fused_mlp.planes_fwd`` and the
composite kernel) and the plain module (``renderer.render_rays``).

- ``kernel_route`` case by case: the kernels on CUDA, in bf16, at widths,
  sample counts and chunk sizes the kernels take, coarse or hierarchical
  with a fine network that is the model or one of its widths; the plain
  module for the CPU, float32, a fine network of other widths, a union
  of coarse and fine depths over ``_MAX_SAMPLES``, a model that is not a
  ``CodeNeRF`` and sizes the kernels do not take (the hierarchical route
  itself: ``tests/test_torch_render_hier_route.py``);
- the kernel route's ray function on CPU tensors, in chunks, where both
  kernels run their plain versions, against the plain module's render
  of the same chunks at the cars
  widths (W 256, 3 + 1 blocks, latent 256, 10 / 4 frequencies, 96
  samples) with weights drawn as a served model's (``_served``). Both
  compute in bf16 and round at different points, so the bar is 0.01
  worst and 0.002 mean absolute in rgb (a level is 0.0039);
- the kernel route's launches: the code projections once, for one row,
  the rays' operands and each kernel once a group of whole chunks of at
  most ``KERNEL_RAYS`` rays;
- a CPU ``render_image`` is the plain route, bit for bit, and
  ``render_image.chunks`` counts the chunks of each route, reported in
  ``RenderServer.timings()``;
- on a CUDA device (skipped without one, decided in the fixture): 128 ×
  128 renders through the kernels no further from the float32 plain
  module than the bf16 plain module is, every chunk counted as
  ``kernels``, and repeated renders with frozen weights packing the
  trunk once.
"""

import math

import pytest
import torch

from codenerf_tpu_torch import renderer, serving
from codenerf_tpu_torch.config import NetConfig, RenderConfig
from codenerf_tpu_torch.core.rays import camera_rays
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.ops import fused_train
from codenerf_tpu_torch.render_orbit import orbit_pose

torch.set_num_threads(2)     # W=256 on the CPU: keep xdist workers apart

CAR = NetConfig(W=256, shape_blocks=3, texture_blocks=1, num_xyz_freq=10,
                num_dir_freq=4, latent_dim=256)
RC = RenderConfig(n_samples=96, near=0.8, far=1.8)
BF16, F32 = torch.bfloat16, torch.float32
MAX_GAP, MEAN_GAP = 0.01, 0.002


def _served(seed: int, cfg: NetConfig = CAR, device="cpu"):
    """A model and one object's codes as the served benchmark draws them:
    every layer's uniform range widened by sqrt(6) (activations of order
    one, as a trained model's), ``rgb_out`` drawn so the colours centre on
    0.5 with a spread of 0.25; codes N(0, 2/latent_dim)."""
    g = torch.Generator().manual_seed(seed)
    model = CodeNeRF(cfg, generator=g).requires_grad_(False)
    for name, lin in model.named_children():
        if name == "rgb_out":
            lin.weight.mul_(0.25 * math.sqrt(3.0))
            lin.bias.mul_(0.025 * math.sqrt(lin.weight.shape[1])).add_(0.5)
        else:
            lin.weight.mul_(math.sqrt(6.0))
            lin.bias.mul_(math.sqrt(6.0))
    D = cfg.latent_dim
    codes = torch.randn(2, D, generator=g) / math.sqrt(D / 2.0)
    return model.to(device), codes[0].to(device), codes[1].to(device)


def _rays(H: int, W: int, seed: int, device="cpu"):
    c2w = orbit_pose(0.7 + 2.1 * seed, 0.1 + 0.2 * seed, 1.3)
    return camera_rays(H, W, 1.1 * W, c2w, device=device)


def _gaps(a: torch.Tensor, b: torch.Tensor):
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def car_model():
    return CodeNeRF(CAR, generator=torch.Generator().manual_seed(0))


# --------------------------------------------------------- route predicate

ROUTES = {
    # id: (overrides, expected route is the kernels)
    "kernels": ({}, True),
    "kernels_shared_fine": ({"fine": True, "rcfg": RenderConfig(
        n_samples=96, share_fine_weights=True)}, True),
    "kernels_chunk_1024": ({"chunk": 1024}, True),
    "cpu": ({"device": "cpu"}, False),
    "float32": ({"dtype": F32}, False),
    "hierarchical": ({"rcfg": RenderConfig(n_samples=96, n_importance=32)},
                     True),
    "separate_fine": ({"fine": True, "rcfg": RenderConfig(
        n_samples=96, share_fine_weights=False)}, True),
    "separate_fine_hierarchical": ({"fine": True, "rcfg": RenderConfig(
        n_samples=64, n_importance=128, share_fine_weights=False)}, True),
    "union_too_many_samples": ({"rcfg": RenderConfig(
        n_samples=96, n_importance=168)}, False),
    "fine_width_512": ({"fine": CodeNeRF(NetConfig(W=512, latent_dim=256)),
                        "rcfg": RenderConfig(n_samples=64, n_importance=128,
                                             share_fine_weights=False)},
                       False),
    "fine_other_blocks": ({"fine": CodeNeRF(NetConfig(shape_blocks=2,
                                                      latent_dim=256)),
                           "rcfg": RenderConfig(n_samples=64,
                                                n_importance=128,
                                                share_fine_weights=False)},
                          False),
    "chunk_not_tiled": ({"chunk": 4080}, False),   # 16 | 4080, 32 does not
    "chunk_not_16": ({"chunk": 4008}, False),
    "too_many_samples": ({"rcfg": RenderConfig(n_samples=264)}, False),
    "width_128": ({"cfg": NetConfig(W=128, latent_dim=256)}, False),
    "width_512": ({"cfg": NetConfig(W=512, latent_dim=256)}, False),
    "not_a_codenerf": ({"wrap": True}, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_kernel_route(case, car_model):
    over, want = ROUTES[case]
    model = car_model
    if "cfg" in over:
        model = CodeNeRF(over["cfg"])
    if over.get("wrap"):
        model = torch.nn.Sequential(model)
        model.cfg = CAR
    fine = over.get("fine")
    got = renderer.kernel_route(
        model, over.get("rcfg", RC), over.get("chunk", 4096),
        over.get("dtype", BF16), torch.device(over.get("device", "cuda")),
        car_model if fine is True else fine)
    assert got is want


# ------------------------------------------- the kernel route on the CPU

def _plain_chunks(model, rcfg, ro, vd, s, t, generator, chunk,
                  dtype=BF16):
    """The plain module's rgb of the rays, chunk by chunk (the order in
    which ``render_image``'s plain route draws the depths)."""
    with torch.no_grad():
        return torch.cat([renderer.render_rays(
            model, rcfg, ro[i:i + chunk], vd[i:i + chunk], s, t, generator,
            compute_dtype=dtype).final.rgb
            for i in range(0, len(ro), chunk)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_rays_match_plain_module(seed):
    model, s, t = _served(seed)
    ro, vd = _rays(16, 16, seed)
    got = renderer.render_rays_kernels(model, RC, ro, vd, s, t, None,
                                       None, 64)
    want = _plain_chunks(model, RC, ro, vd, s, t, None, 64)
    assert got.shape == want.shape == (256, 3) and got.dtype == F32
    worst, mean = _gaps(got, want)
    assert worst < MAX_GAP and mean < MEAN_GAP, (worst, mean)


@pytest.mark.parametrize("white_bg", [True, False])
def test_kernel_rays_stratified_within_sphere(white_bg):
    """The same coarse depths on both routes: stratified, drawn chunk by
    chunk from generators of one seed, inside the bounding sphere; either
    background."""
    rcfg = RenderConfig(n_samples=96, near=0.8, far=1.8, white_bg=white_bg,
                        bound_sphere_radius=0.6)
    model, s, t = _served(3)
    ro, vd = _rays(16, 16, 1)
    got = renderer.render_rays_kernels(
        model, rcfg, ro, vd, s, t, torch.Generator().manual_seed(5), None,
        128)
    want = _plain_chunks(model, rcfg, ro, vd, s, t,
                         torch.Generator().manual_seed(5), 128)
    worst, mean = _gaps(got, want)
    assert worst < MAX_GAP and mean < MEAN_GAP, (worst, mean)


@pytest.mark.parametrize("kernel_rays", [64, 128, 200, 4096])
def test_kernel_rays_launch_groups(kernel_rays, monkeypatch):
    """The code projections are computed once, for one row; the rays'
    operands, the depths and one launch of each kernel cover a group of
    whole chunks of at most ``KERNEL_RAYS`` rays (one chunk when a chunk
    is larger), so device memory is bounded by the group, not the image;
    the rgb is the same as with the whole image in one group."""
    model, s, t = _served(8)
    ro, vd = _rays(16, 16, 2)
    whole = renderer.render_rays_kernels(model, RC, ro, vd, s, t, None,
                                         None, 256)
    rays, codes, launches = [], [], []
    ray_ops, code_ops, planes = (renderer.fused_mlp.ray_operands,
                                 renderer.fused_mlp.code_operands,
                                 renderer.fused_mlp.planes_fwd)

    def ray_spy(model, cfg, ray_o, viewdir):
        rays.append(ray_o.shape[0])
        return ray_ops(model, cfg, ray_o, viewdir)

    def code_spy(model, cfg, sc, tc):
        codes.append((tuple(sc.shape), tuple(tc.shape)))
        return code_ops(model, cfg, sc, tc)

    def planes_spy(cfg, S, R, *args):
        launches.append(R)
        return planes(cfg, S, R, *args)

    monkeypatch.setattr(renderer, "KERNEL_RAYS", kernel_rays)
    monkeypatch.setattr(renderer.fused_mlp, "ray_operands", ray_spy)
    monkeypatch.setattr(renderer.fused_mlp, "code_operands", code_spy)
    monkeypatch.setattr(renderer.fused_mlp, "planes_fwd", planes_spy)
    got = renderer.render_rays_kernels(model, RC, ro, vd, s, t, None,
                                       None, 64)
    group = 64 * max(1, kernel_rays // 64)
    assert rays == launches == [min(group, 256 - k)
                                for k in range(0, 256, group)]
    assert codes == [((1, CAR.latent_dim), (1, CAR.latent_dim))]
    worst, _ = _gaps(got, whole)
    assert worst <= 1e-6, worst


# ------------------------------------------------ render_image's routes

def test_cpu_render_image_is_the_plain_route():
    """On the CPU every chunk goes through ``render_rays`` on the plain
    module, bit for bit as before the kernel route existed; the chunks
    count as ``plain``."""
    model, s, t = _served(4, NetConfig(W=64, shape_blocks=2, latent_dim=32))
    rcfg = RenderConfig(n_samples=16)
    before = dict(renderer.render_image.chunks)
    c2w = orbit_pose(0.3, 0.4, 1.3)
    img = renderer.render_image(model, rcfg, 12, 12, 13.2, c2w, s, t,
                                chunk=64)
    chunk, n_chunks, n_padded = renderer.chunk_plan(144, 64)
    ro, vd = camera_rays(12, 12, 13.2, c2w)
    ro, vd = renderer.pad_rays(ro, n_padded), renderer.pad_rays(vd, n_padded)
    with torch.no_grad():
        want = torch.cat([renderer.render_rays(
            model, rcfg, ro[i * chunk:(i + 1) * chunk],
            vd[i * chunk:(i + 1) * chunk], s, t, None).final.rgb
            for i in range(n_chunks)])[:144].reshape(12, 12, 3)
    assert torch.equal(img, want)
    after = renderer.render_image.chunks
    assert after["plain"] - before["plain"] == n_chunks == 3
    assert after["kernels"] == before["kernels"]


def test_render_image_kernel_chunks_counted(monkeypatch):
    """With the route taken (forced here: on the CPU the predicate never
    takes it), ``render_image`` runs the kernel chunk function on every
    padded chunk, crops and reshapes like the plain route, and counts the
    chunks as ``kernels``."""
    model, s, t = _served(5)
    c2w = orbit_pose(1.1, 0.3, 1.3)
    plain = renderer.render_image(model, RC, 12, 12, 13.2, c2w, s, t,
                                  chunk=64)
    before = dict(renderer.render_image.chunks)
    monkeypatch.setattr(renderer, "kernel_route", lambda *a, **k: True)
    img = renderer.render_image(model, RC, 12, 12, 13.2, c2w, s, t,
                                chunk=64)
    after = renderer.render_image.chunks
    assert after["kernels"] - before["kernels"] == 3
    assert after["plain"] == before["plain"]
    assert img.shape == (12, 12, 3)
    worst, mean = _gaps(img, plain)
    assert worst < MAX_GAP and mean < MEAN_GAP, (worst, mean)


def test_server_timings_report_the_chunks():
    """``timings()`` (``GET /timings``) carries the counter; ``/stats``
    keeps the fields it had."""
    model, s, t = _served(6, NetConfig(W=64, shape_blocks=2, latent_dim=32))
    hp = type("Hp", (), {"render": RenderConfig(n_samples=16),
                         "compute_dtype": "bfloat16"})()
    server = serving.RenderServer({"model": model, "fine_model": None,
                                   "shape_codes": s[None].repeat(2, 1),
                                   "texture_codes": t[None].repeat(2, 1)},
                                  hp)
    try:
        before = server.timings()["chunks"]
        server.render({"obj": 1, "H": 8, "W": 8})
        after = server.timings()["chunks"]
        assert after["plain"] - before["plain"] == 1
        assert after["kernels"] == before["kernels"]
        assert set(server.stats()) == {"requests", "latency_ms",
                                       "compiled_sizes"}
    finally:
        server.shutdown()


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel route runs only there")
    return torch.device("cuda")


def test_render_image_on_the_card(card):
    """128 × 128 renders through the kernels, held with the bf16 plain
    module to the float32 plain module on the same rays (the same chunks
    through ``render_rays``): the kernel route about as exact, its mean
    gap within 1.1 times the plain module's (0.85-0.94 times on the card
    over eight served views, 1.01 once on the CPU) and its worst pixel
    within a level (1/255) of the plain module's worst. (Between the two
    bf16 routes the worst pixel reaches 0.0118 at this size, past the CPU
    tests' 0.01: they round at different points.) Every chunk counted as
    ``kernels``; three renders with frozen weights pack the trunk once."""
    model, s, t = _served(7, device=card)
    chunk, n_chunks, _ = renderer.chunk_plan(128 * 128, 4096)
    assert renderer.kernel_route(model, RC, chunk, BF16, card)
    chunks0 = dict(renderer.render_image.chunks)
    builds0 = fused_train.trunk_operands.builds
    for seed in range(3):
        c2w = orbit_pose(0.7 + 2.1 * seed, 0.1 + 0.2 * seed, 1.3)
        img = renderer.render_image(model, RC, 128, 128, 140.8, c2w, s, t)
        ro, vd = camera_rays(128, 128, 140.8, c2w, device=card)
        plain = {dtype: _plain_chunks(model, RC, ro, vd, s, t, None, chunk,
                                      dtype)
                 for dtype in (BF16, F32)}
        k_max, k_mean = _gaps(img.reshape(-1, 3), plain[F32])
        p_max, p_mean = _gaps(plain[BF16], plain[F32])
        assert k_mean <= 1.1 * p_mean, (seed, k_mean, p_mean)
        assert k_max <= p_max + 1.0 / 255.0, (seed, k_max, p_max)
    chunks = renderer.render_image.chunks
    assert chunks["kernels"] - chunks0["kernels"] == 3 * n_chunks
    assert chunks["plain"] == chunks0["plain"]
    assert fused_train.trunk_operands.builds - builds0 == 1
