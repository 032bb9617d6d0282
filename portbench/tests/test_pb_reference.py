"""The plain reference against the port at a small size on the CPU: the
positional encoding, the network, rays, depths, the composite, AdamW and
the served render. The
port computes in float32 here, so the two agree to float32 rounding."""

import math

import numpy as np
import pytest
import torch

from codenerf_tpu_torch.config import NetConfig, RenderConfig
from codenerf_tpu_torch.core import rays, render, sampling
from codenerf_tpu_torch.core.encoding import positional_encoding
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.render_orbit import orbit_pose
from codenerf_tpu_torch.renderer import render_image
from portbench.harness.weights import make_weights
from portbench.reference import codenerf as ref
from portbench.reference import render as ref_render
from portbench.reference.train import adamw_

NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 64, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": 16}


@pytest.fixture
def nets():
    init = make_weights(NET, 5, 3, "cpu", gain=math.sqrt(6.0))
    model = CodeNeRF(NetConfig(**NET))
    model.load_state_dict({k: v for k, v in init.items()
                           if not k.endswith("codes")})
    return init, model


def _close(a, b, tol=1e-5):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    assert torch.allclose(a, b, rtol=tol, atol=tol), \
        float((a - b).abs().max())


def test_encoding():
    x = torch.randn(7, 3)
    _close(ref.positional_encoding(x, 6), positional_encoding(x, 6))


def test_network(nets):
    init, model = nets
    g = torch.Generator().manual_seed(1)
    xyz = torch.rand(4, 9, 3, generator=g) - 0.5
    vd = torch.nn.functional.normalize(torch.randn(4, 3, generator=g), dim=-1)
    sc, tc = init["shape_codes"][:4], init["texture_codes"][:4]
    s1, c1 = ref.forward(init, NET, xyz, vd, sc, tc, ref.Precision("f32"))
    s2, c2 = model(xyz, vd, sc, tc, compute_dtype=torch.float32)
    _close(s1, s2)
    _close(c1, c2)


def test_rays_depths_composite():
    g = torch.Generator().manual_seed(2)
    poses = torch.from_numpy(np.stack([orbit_pose(a, 0.3, 1.3)
                                       for a in (0.1, 1.0, 2.0)]))
    uv = torch.randint(0, 16, (3, 2), generator=g)
    focal = torch.full((3,), 17.6)
    o1, d1 = ref.pixel_rays(uv, focal, poses, 16, 16)
    o2, d2 = rays.pixel_rays(uv, focal, poses, 16, 16)
    _close(o1, o2)
    _close(d1, d2)
    jit = torch.randint(0, 256, (3, 8), generator=g).float() / 256.0
    _close(ref.stratified_z(0.8, 1.8, jit),
           sampling.stratified_zvals(None, 0.8, 1.8, 8, 3, jitter=jit))
    sigma = torch.rand(3, 8, generator=g) * 3
    rgb = torch.rand(3, 8, 3, generator=g)
    z = ref.stratified_z(0.8, 1.8, jit)
    out, w = ref.composite(sigma, rgb, z)
    want = render.composite(sigma, rgb, z)
    _close(out, want.rgb)
    _close(w, want.weights)


def test_adamw():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(5, 3, generator=g)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    opt = torch.optim.AdamW([b], lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    st = [{"m": torch.zeros_like(a), "v": torch.zeros_like(a)}]
    for t in range(1, 4):
        grad = torch.randn(5, 3, generator=g)
        a.grad, b.grad = grad.clone(), grad.clone()
        adamw_([a], st, 1e-2, 0.01, t)
        opt.step()
    _close(a.detach(), b.detach(), 1e-6)


def test_served_render(nets):
    init, model = nets
    hp = {"N_samples": 12, "near": 0.8, "far": 1.8, "net_hyperparams": NET}
    c2w = ref_render.orbit_c2w(0.7, 0.3, 1.3)
    assert np.allclose(c2w, orbit_pose(0.7, 0.3, 1.3), atol=1e-6)
    got = ref_render.render(init, hp, init["shape_codes"][1],
                            init["texture_codes"][1], c2w, 8, 8, 8.8)
    img = render_image(model, RenderConfig(n_samples=12), 8, 8, 8.8,
                       torch.from_numpy(c2w), init["shape_codes"][1],
                       init["texture_codes"][1], compute_dtype=torch.float32)
    want = np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
