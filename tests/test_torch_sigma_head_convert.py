"""The plain versions of the sigma-only head and of the code cotangents'
conversion (on the CPU) against the JAX package, on the same seeded
inputs (W=256, 2 shape blocks, 1 texture block, R=32 rays); and the two
kernels' standalone CUDA wrappers refusing what the kernels do not take.

- ``sigma_head_plain`` on the port's plain forward's t against the JAX
  sigma-only kernel (``invoke_fwd(..., sigma_only=True)``, Pallas in
  interpret mode) at S = 32 and 64; ``sigma_fwd_plain`` is the plain
  forward then that head, bit for bit.
- ``sigma_head_plain`` bit-equal to ``plane_head_plain``'s sigma plane on
  the same t (the CUDA kernels share that lane too).
- ``fold_ray_sums_plain`` (the code cotangents' last pass) bit-equal to
  ``jnp.asarray(x).astype(jnp.bfloat16)`` of each segment of the rays'
  span where every ray lies within one 16-point slice (S = 16: the pass
  only rounds), on seeded f32 values with exact rounding ties (both
  directions), ±0, subnormals and values near the bf16 maximum (and past
  it, which round to infinity) at the head of every segment.

Tolerances, each with its reason. The sigma head: the port's t differs
from the JAX kernel's by f32 summation order, which flips an occasional
bf16 rounding of t — ``test_torch_fused_train``'s bar (relative L2 below
5e-3, each element within 1e-2 of the largest magnitude plus 5e-3
relative). Everything else is exact: the same operations on the same
values, or a rounding that both packages define as round to nearest even.
"""

import contextlib
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


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """W=256 on the CPU beside the other test workers: two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
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


@pytest.mark.parametrize("S", [32, 64])
def test_sigma_head_plain_matches_jax_sigma_only(S):
    """``sigma_head_plain`` on the port's plain forward's t against the
    JAX sigma-only kernel on the same weights and per-ray operands."""
    seed = 7
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
    wb = [x.astype(jnp.bfloat16) if x.ndim == 2 else x
          for x in j_ft.flatten_params_f32(jparams, jcfg)]
    want = np.asarray(j_fused_mlp.invoke_fwd(jcfg, S, R, *ops, wb,
                                             sigma_only=True), np.float32)

    tops = (_t(ops[0]), _t(ops[1]), _t(ops[2]),
            *(_t(x, torch.bfloat16) for x in ops[3:]))
    wflat = fused_train.flatten_params(model, cfg)
    wops = fused_train.kernel_operands(wflat)
    # Both computations below on one thread: the bit-equality at the end
    # wants the same f32 summation order in both, and a multi-threaded
    # MKL sgemm under a loaded machine does not promise one.
    with _one_thread():
        t = fused_mlp.shape_trunk_plain(cfg, R, S, *tops[:4], wops)["t"]
        whole = fused_mlp.sigma_fwd_plain(cfg, S, R, *tops, wflat)
    i_sig = cfg.shape_blocks + 2
    got = fused_mlp.sigma_head_plain(R, S, t, wops[2 * i_sig],
                                     wops[2 * i_sig + 1])
    assert got.shape == (R, S) and got.dtype == torch.float32
    g = got.numpy()
    top = float(np.abs(want).max())
    assert top > 0
    assert np.linalg.norm(g - want) / np.linalg.norm(want) < 5e-3
    np.testing.assert_allclose(g, want, rtol=5e-3, atol=1e-2 * top)
    np.testing.assert_array_equal(whole.numpy(), g)


def _head_operands(R_, S, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return dict(
        R=R_, S=S,
        t=torch.randn(R_ * S, 256, generator=gen).to(torch.bfloat16),
        r=torch.randn(R_ * S, 128, generator=gen).to(torch.bfloat16),
        w_sig=torch.randn(256, generator=gen) * 0.1,
        b_sig=torch.randn(1, generator=gen),
        w_rgb=torch.randn(128, 8, generator=gen).to(torch.bfloat16),
        b_rgb=torch.randn(8, generator=gen))


@pytest.mark.parametrize("R_,S", [(R, 32), (7, 13)])
def test_sigma_head_plain_is_plane_head_sigma(R_, S):
    """The sigma-only head and the four-plane head's sigma plane are one
    function: the same bits on the same t."""
    ops = _head_operands(R_, S)
    planes = fused_mlp.plane_head_plain(**ops)
    sigma = fused_mlp.sigma_head_plain(R_, S, ops["t"], ops["w_sig"],
                                       ops["b_sig"])
    assert sigma.shape == (R_, S) and bool(torch.isfinite(sigma).all())
    np.testing.assert_array_equal(sigma.numpy(), planes[0].numpy())


def _span_values(R_, nb, nt, W, seed):
    """Seeded f32 cotangent sums, each segment headed by the values where
    rounding to bf16 is delicate."""
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                     0x00008000, 0x00018000, 0x7F7E8000, 0x7F7F8000],
                    np.uint32).view(np.float32)   # halfway, even/odd below
    special = np.concatenate([ties, np.array(
        [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, 2.0 ** -126, -(2.0 ** -127),
         3.3895e38, -3.3895e38, 3.3961e38, 3.4e38, -3.4e38,
         np.finfo(np.float32).max, 1.0 + 2.0 ** -9, 1.0 - 2.0 ** -10],
        np.float32)])
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=R_ * (nb + nt + 1) * W)
         * np.exp(rng.uniform(-20, 20, R_ * (nb + nt + 1) * W))
         ).astype(np.float32)
    for start in (0, R_ * nb * W, R_ * (nb + nt) * W):
        x[start:start + special.size] = special
    return x


@pytest.mark.parametrize("nb,nt", [(2, 1), (3, 2)])
def test_rowsums_to_bf16_plain_matches_jax_astype(nb, nt):
    """Each output of ``fold_ray_sums_plain`` is the bits of
    ``jnp.astype(bf16)`` of its segment of the rays' span, in its shape,
    when every ray lies within one slice (the slice rows, all NaN, are not
    read)."""
    W, S = 256, 16
    x = _span_values(R, nb, nt, W, seed=nb)
    slices = torch.full((fused_train.slice_rows(R, S) * (nb + nt + 1) * W,),
                       float("nan"))
    got = fused_train.fold_ray_sums_plain(torch.from_numpy(x), slices, R, S,
                                          nb, nt, W)
    n_s, n_t = R * nb * W, R * nt * W
    segs = (x[:n_s].reshape(R, nb, W), x[n_s:n_s + n_t].reshape(R, nt, W),
            x[n_s + n_t:].reshape(R, W))
    for name, g, seg in zip(("d_sproj", "d_tproj", "d_vcontrib"), got, segs):
        want = np.asarray(jnp.asarray(seg).astype(jnp.bfloat16))
        assert g.dtype == torch.bfloat16 and g.shape == seg.shape, name
        np.testing.assert_array_equal(
            g.view(torch.int16).numpy().view(np.uint16),
            want.view(np.uint16), err_msg=name)
    # the delicate values really are delicate: ties both ways, subnormals
    # kept, the largest finite values kept or rounded to infinity
    head = got[0].reshape(-1)[:23].float().numpy()
    assert head[0] == 1.0 and head[1] == np.float32(1.015625)
    assert head[9] == 0.0 and np.signbit(head[9])
    assert head[10] > 0 and np.isfinite(head[15])
    assert np.isinf(head[18]) and np.isinf(head[19])


def _sigma_operands():
    ops = _head_operands(8, 16, seed=4)
    return {k: ops[k] for k in ("R", "S", "t", "w_sig", "b_sig")}


# (operand changes, the error's words): each a case the CUDA wrapper must
# refuse before it reaches the kernel.
SIGMA_REFUSALS = {
    "cpu": ({}, "CUDA tensors"),
    "dtype": ({"t": lambda o: o["t"].float()}, "dtype"),
    "w_sig_dtype": ({"w_sig": lambda o: o["w_sig"].double()}, "dtype"),
    "shape": ({"t": lambda o: o["t"][:, :128].contiguous()}, "shape"),
    "b_sig_shape": ({"b_sig": lambda o: torch.zeros(2)}, "shape"),
    "contiguity": ({"t": lambda o: o["t"].t().contiguous().t()},
                   "contiguous"),
}


@pytest.mark.parametrize("case", list(SIGMA_REFUSALS))
def test_sigma_head_wrapper_refuses(case):
    """``fused_mlp.sigma_head`` launches the CUDA kernel on CUDA tensors
    only, and raises on a wrong dtype, shape or layout before the device
    is looked at; it never falls back to the plain version and counts no
    launch."""
    ops = _sigma_operands()
    changes, words = SIGMA_REFUSALS[case]
    ops.update({k: f(ops) for k, f in changes.items()})
    before = fused_mlp.sigma_head.launches
    with pytest.raises(ValueError, match=words):
        fused_mlp.sigma_head(**ops)
    assert fused_mlp.sigma_head.launches == before


def _span_operands():
    return dict(x=torch.from_numpy(_span_values(4, 2, 1, 256, seed=9)),
                sl=torch.zeros(fused_train.slice_rows(4, 96) * 4 * 256),
                R=4, S=96, nb=2, nt=1, W=256)


ROWSUM_REFUSALS = {
    "cpu": ({}, "CUDA tensors"),
    "dtype": ({"x": lambda o: o["x"].double()}, "dtype"),
    "bf16": ({"sl": lambda o: o["sl"].to(torch.bfloat16)}, "dtype"),
    "shape": ({"x": lambda o: o["x"][:-256].contiguous()}, "shape"),
    "layout": ({"sl": lambda o: o["sl"].view(4, -1)}, "shape"),
    "contiguity": ({"x": lambda o: torch.stack(
        [o["x"], o["x"]], 1)[:, 0]}, "contiguous"),
    "W": ({"W": lambda o: 252, "x": lambda o: torch.zeros(4 * 4 * 252)},
          "multiple of 8"),
    "nt": ({"nt": lambda o: 0}, "nt"),
}


@pytest.mark.parametrize("case", list(ROWSUM_REFUSALS))
def test_rowsums_to_bf16_wrapper_refuses(case):
    """``fused_train.fold_ray_sums`` likewise: CUDA tensors only; a wrong
    dtype, shape, layout, W or block count in either span raises before
    the device is looked at."""
    ops = _span_operands()
    changes, words = ROWSUM_REFUSALS[case]
    ops.update({k: f(ops) for k, f in changes.items()})
    before = fused_train.fold_ray_sums.launches
    with pytest.raises(ValueError, match=words):
        fused_train.fold_ray_sums(**ops)
    assert fused_train.fold_ray_sums.launches == before
