"""The plain versions of the input-chain kernel and of the four-plane head
(on the CPU) against the JAX package's Pallas kernels in interpret mode,
on the same seeded inputs (W=256, 2 shape blocks, 10 PE frequencies,
R=32 rays); and the two kernels' standalone CUDA wrappers refusing what
the kernels do not take.

- ``input_chain_plain`` on the enc_xyz cotangent ``gh0`` as the JAX
  kernel itself formed it (recorded at its ``dot_t`` with the enc_xyz
  weight) against the JAX kernel's ``d_ro8``, ``d_vd8`` and ``d_z``: the
  plane-op backward's tail (``_invoke_bwd``, input gradients only, where
  ``d_z`` is the chain's xyz term alone) at S = 32, 64 and 96, and the
  single pass's tail (``invoke_train_fused``, the pose mode) at S = 32
  with the composite's own dz recorded too. Every case has points at
  which the top frequency's t = x·2^9 exceeds 100.
- ``plane_head_plain`` on the port's plain forward's t and r against the
  JAX four-plane kernel's sigma, r, g and b (``invoke_fwd``), as
  ``tests/test_torch_plane_ops.py::test_planes_fwd_plain_matches_jax``.

Tolerances, each with its reason. The input chain: both sides take the
same bf16 gh0 and W_enc and the same f32 depths; they differ by the f32
summation order of d_pe (256 exact products), of d_xyz over the PE lanes
and of the per-ray sums, and by the two packages' f32 sin and cos, which
at arguments up to ~1600 (an ulp of t is 1.2e-4 there) differ in their
last digits; each lane's term carries its factor 2^i, up to 512, so the
top frequencies dominate d_xyz and its error. Measured: up to 3.5e-5
relative L2 and 5.2e-5 of the largest magnitude. The bar: relative L2
below 2e-4 per output and every element within 3e-4 of the output's
largest magnitude; a flipped bf16 rounding of one gh0 element (which the
shared gh0 rules out) moves a point by ~4e-3 of its term, a wrong lane or
sign by its whole size. The planes: the
port's t and r differ from the JAX kernel's by f32 summation order,
which flips an occasional bf16 rounding — ``test_torch_fused_train``'s
bar (relative L2 below 5e-3, each element within 1e-2 of the largest
magnitude plus 5e-3 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu.config import NetConfig as JNetConfig
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.ops import fused_mlp as j_fused_mlp
from codenerf_tpu.ops import fused_train as j_ft
from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.ops import fused_mlp, fused_train

R = 32
KW = dict(shape_blocks=2, texture_blocks=1, W=256, num_xyz_freq=10)
INPUT_CHAIN = ("d_ro8", "d_vd8", "d_z")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """W=256 on the CPU beside the other test workers: two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched, raising=True)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _setup(S, seed=3):
    """Seeded W=256 weights in both packages and the per-ray operands from
    the JAX prologue; origins and depths spread so that |x| reaches ~2."""
    jcfg = JNetConfig(**KW)
    jparams = init_codenerf(jax.random.PRNGKey(seed), jcfg)
    cfg = NetConfig(**dataclasses.asdict(jcfg))
    model = CodeNeRF(cfg).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.3, 2.2, (R, S)), -1).astype(np.float32)
    sc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    ops = j_fused_mlp.prep_ray_operands(
        jparams, jcfg, jnp.asarray(ro), jnp.asarray(vd), jnp.asarray(z),
        jnp.asarray(sc), jnp.asarray(tc))
    jw = j_ft.flatten_params_f32(jparams, jcfg)
    tops = (_t(ops[0]), _t(ops[1]), _t(ops[2]),
            *(_t(x, torch.bfloat16) for x in ops[3:]))
    return dict(jcfg=jcfg, cfg=cfg, ops=ops, jw=jw, tops=tops,
                tw=fused_train.flatten_params(model, cfg), rng=rng)


def _recording(seen):
    """A ``_tile_helpers`` whose ``dot_t`` records its cotangent operand
    when the weight is enc_xyz's (the only (64, W) one): the kernel's
    gh0, one array per tile, in the grid's order."""
    helpers = j_ft._tile_helpers

    def recording_helpers(*args, **kwargs):
        h = helpers(*args, **kwargs)
        dot_t = h.dot_t

        def recorded(g, wm):
            if wm.shape[0] == 64:
                jax.debug.callback(lambda g: seen.append(np.asarray(g)), g)
            return dot_t(g, wm)

        h.dot_t = recorded
        return h

    return recording_helpers


def _top_t(k, S):
    """The largest |t| of the top PE frequency at these points."""
    ro8, vd8, z = k["tops"][:3]
    x = ro8[:, None, :3] + vd8[:, None, :3] * z[:, :, None]
    return float(x.abs().max()) * 2.0 ** (KW["num_xyz_freq"] - 1)


def _close_chain(got, want, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    top = float(np.abs(want).max())
    assert top > 0, name
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 2e-4, (name, rel_l2)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4 * top,
                               err_msg=name)


@pytest.mark.parametrize("route,S", [("plane_bwd", 32), ("plane_bwd", 64),
                                     ("plane_bwd", 96),
                                     ("single_pass", 32)])
def test_input_chain_plain_matches_jax_tail(route, S):
    """``input_chain_plain`` on the JAX kernel's own gh0 (and, in the
    single pass, its own composite dz) against the JAX kernel's d_ro8,
    d_vd8 and d_z."""
    k = _setup(S)
    assert _top_t(k, S) > 100.0
    seen, dz_seen = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(j_ft, "_tile_helpers", _recording(seen))
    try:
        if route == "plane_bwd":
            rng = k["rng"]
            gp = [jnp.asarray(rng.normal(size=(R, S)).astype(np.float32)
                              * 1e-2) for _ in range(4)]
            out = j_ft._invoke_bwd(k["jcfg"], S, R, *k["ops"], k["jw"],
                                   tuple(gp), weight_grads=False,
                                   input_grads=True)
            want = out[:3]
        else:
            bwd = j_fused_mlp.composite_bwd_in_kernel

            def recorded_bwd(*args):
                res = bwd(*args)
                jax.debug.callback(lambda d: dz_seen.append(np.asarray(d)),
                                   res[4])
                return res

            mp.setattr(j_fused_mlp, "composite_bwd_in_kernel", recorded_bwd)
            gt8 = j_fused_mlp._pad_lanes(jnp.asarray(
                k["rng"].uniform(0.0, 1.0, (R, 3)).astype(np.float32)), 8)
            out = j_ft.invoke_train_fused(
                k["jcfg"], S, R, True, 1.0 / (3.0 * R), *k["ops"], gt8,
                k["jw"], weight_grads=False, input_grads=True)
            want = out[-3:]
        jax.block_until_ready(want)
    finally:
        mp.undo()
    gh0 = _t(np.concatenate(seen), torch.bfloat16)   # the tiles in order
    assert gh0.shape == (R * S, 256) and float(gh0.float().abs().max()) > 0
    if route == "plane_bwd":
        dz_comp = torch.zeros(R, S)
    else:
        dz_comp = _t(np.concatenate(dz_seen))
        assert dz_comp.shape == (R, S)
    wops = fused_train.kernel_operands(k["tw"])
    ro8, vd8, z = k["tops"][:3]
    got = fused_mlp.input_chain_plain(R, S, ro8, vd8, z, gh0, wops[0],
                                      dz_comp, KW["num_xyz_freq"])
    for name, g, w in zip(INPUT_CHAIN, got, want):
        _close_chain(g.numpy(), w, f"{name} ({route}, S={S})")


@pytest.mark.parametrize("S", [16, 64])
def test_plane_head_plain_matches_jax(S):
    """``plane_head_plain`` on the port's plain forward's t and r against
    the JAX four-plane kernel; ``planes_fwd_plain`` is the plain forward
    then that head, bit for bit."""
    k = _setup(S, seed=5)
    cfg = k["cfg"]
    wb = [x.astype(jnp.bfloat16) if x.ndim == 2 else x for x in k["jw"]]
    want = j_fused_mlp.invoke_fwd(k["jcfg"], S, R, *k["ops"], wb)
    wops = fused_train.kernel_operands(k["tw"])
    acts = fused_mlp.forward_plain(cfg, R, S, *k["tops"], wops)
    i_sig = cfg.shape_blocks + 2
    i_rgbo = cfg.shape_blocks + cfg.texture_blocks + 5
    got = fused_mlp.plane_head_plain(
        R, S, acts["t"], acts["r"], wops[2 * i_sig], wops[2 * i_sig + 1],
        wops[2 * i_rgbo], wops[2 * i_rgbo + 1])
    for name, g, w in zip(("sigma", "r", "g", "b"), got, want):
        assert g.shape == (R, S) and g.dtype == torch.float32, name
        g, w = g.numpy(), np.asarray(w, np.float32)
        top = float(np.abs(w).max())
        assert top > 0, name
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 5e-3, name
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-2 * top,
                                   err_msg=name)
    planes = fused_mlp.planes_fwd_plain(cfg, S, R, *k["tops"], k["tw"])
    for a, b in zip(planes, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _chain_operands(R_=8, S=16):
    gen = torch.Generator().manual_seed(0)
    return dict(
        R=R_, S=S, ro8=torch.rand(R_, 8, generator=gen),
        vd8=torch.rand(R_, 8, generator=gen),
        z=torch.rand(R_, S, generator=gen),
        gh0=torch.randn(R_ * S, 256, generator=gen).to(torch.bfloat16),
        w_enc=torch.randn(64, 256, generator=gen).to(torch.bfloat16),
        dz_comp=torch.zeros(R_, S), num_freqs=10)


def _head_operands(R_=8, S=16):
    gen = torch.Generator().manual_seed(1)
    return dict(
        R=R_, S=S,
        t=torch.randn(R_ * S, 256, generator=gen).to(torch.bfloat16),
        r=torch.randn(R_ * S, 128, generator=gen).to(torch.bfloat16),
        w_sig=torch.randn(256, generator=gen),
        b_sig=torch.randn(1, generator=gen),
        w_rgb=torch.randn(128, 8, generator=gen).to(torch.bfloat16),
        b_rgb=torch.randn(8, generator=gen))


# (operand changes, the error's words): each a case the CUDA wrapper must
# refuse before it reaches the kernel.
CHAIN_REFUSALS = {
    "cpu": ({}, "CUDA tensors"),
    "dtype": ({"gh0": lambda o: o["gh0"].float()}, "dtype"),
    "z_dtype": ({"z": lambda o: o["z"].double()}, "dtype"),
    "shape": ({"w_enc": lambda o: o["w_enc"][:32]}, "shape"),
    "contiguity": ({"gh0": lambda o: o["gh0"].t().contiguous().t()},
                   "contiguous"),
    "S_over_256": ({"S": lambda o: 257, "z": lambda o: torch.zeros(8, 257),
                    "gh0": lambda o: torch.zeros(8 * 257, 256,
                                                 dtype=torch.bfloat16),
                    "dz_comp": lambda o: torch.zeros(8, 257)}, "S <= 256"),
    "n_freq": ({"num_freqs": lambda o: 11}, "num_freqs"),
}


@pytest.mark.parametrize("case", list(CHAIN_REFUSALS))
def test_input_chain_wrapper_refuses(case):
    """``fused_mlp.input_chain`` launches the CUDA kernel on CUDA tensors
    only, and raises on a wrong dtype, shape, layout, S > 256 or too many
    PE lanes (checked before the device); it never falls back to the
    plain version and counts no launch."""
    ops = _chain_operands()
    changes, words = CHAIN_REFUSALS[case]
    ops.update({k: f(ops) for k, f in changes.items()})
    before = fused_mlp.input_chain.launches
    with pytest.raises(ValueError, match=words):
        fused_mlp.input_chain(**ops)
    assert fused_mlp.input_chain.launches == before


HEAD_REFUSALS = {
    "cpu": ({}, "CUDA tensors"),
    "dtype": ({"r": lambda o: o["r"].float()}, "dtype"),
    "w_rgb_dtype": ({"w_rgb": lambda o: o["w_rgb"].float()}, "dtype"),
    "shape": ({"t": lambda o: o["t"][:, :128].contiguous()}, "shape"),
    "contiguity": ({"t": lambda o: o["t"].t().contiguous().t()},
                   "contiguous"),
}


@pytest.mark.parametrize("case", list(HEAD_REFUSALS))
def test_plane_head_wrapper_refuses(case):
    """``fused_mlp.plane_head`` likewise: CUDA tensors only; a wrong
    dtype, shape or layout raises before the device is looked at."""
    ops = _head_operands()
    changes, words = HEAD_REFUSALS[case]
    ops.update({k: f(ops) for k, f in changes.items()})
    before = fused_mlp.plane_head.launches
    with pytest.raises(ValueError, match=words):
        fused_mlp.plane_head(**ops)
    assert fused_mlp.plane_head.launches == before
