"""The plain version of the dx kernel's per-ray code-cotangent sums
(``ray_sums`` in ``ops/csrc/train_fused.cu``): one partial row per ray
and 16-row warp slice (``fused_train.ray_sums_plain``: the ray's own row
for the slice where it starts, the slice's row for a ray that started
before it), then the fixed-order addition of those rows
(``fold_ray_sums_f32``, the order of ``ray_sum_fold_kernel``), held
against the direct per-ray sum at ragged R × S where rays straddle the
kernel's 128-point tiles and the slices (S = 96, 33, 200, 40) and where
several rays share a slice (S = 5, 16).

Tolerances: on values that are multiples of 1/16 below 4, every partial
sum is exact in f32, so any order gives the same bits: equality. On
normal draws the two orders differ by f32 rounding: within 1e-5 of the
double-precision sum's magnitude plus 1e-6.
"""

import numpy as np
import pytest
import torch

from codenerf_tpu_torch.ops import fused_train

SHAPES = [(7, 96), (5, 33), (3, 200), (9, 16), (11, 5), (6, 128), (13, 40)]


def _dyadic(R, S, C, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(-64, 64, size=(R * S, C)).astype(np.float32) / 16)


@pytest.mark.parametrize("R,S", SHAPES)
def test_two_stage_sum_is_the_per_ray_sum(R, S):
    """Slots, then the fixed-order reduction, equal the direct per-ray sum
    exactly on values whose partial sums are all exact; no entry that the
    first stage leaves unwritten (NaN) is read."""
    g = _dyadic(R, S, 12, seed=R * S)
    rays, slices = fused_train.ray_sums_plain(g, R, S)
    assert slices.shape == (fused_train.slice_rows(R, S), 12)
    assert bool(torch.isfinite(rays).all())
    got = fused_train.fold_ray_sums_f32(rays, slices, R, S)
    assert torch.equal(got, g.view(R, S, 12).sum(1))


@pytest.mark.parametrize("R,S", SHAPES)
def test_two_stage_sum_close_on_normal_draws(R, S):
    g = torch.from_numpy(np.random.default_rng(S).normal(
        size=(R * S, 16)).astype(np.float32))
    got = fused_train.fold_ray_sums_f32(*fused_train.ray_sums_plain(g, R, S),
                                        R, S).double()
    want = g.double().view(R, S, 16).sum(1)
    assert float((got - want).abs().max()) <= \
        1e-5 * float(want.abs().max()) + 1e-6


@pytest.mark.parametrize("R,S", [(8, 96), (4, 200), (16, 33), (8, 40),
                                 (9, 5)])
def test_each_slice_row_is_written_once_by_the_ray_before_it(R, S):
    """Every ray's own row is written (its first slice's partial); a
    slice's row is written exactly when a ray started before the slice
    and reaches into it."""
    rays, slices = fused_train.ray_sums_plain(_dyadic(R, S, 4, seed=1), R,
                                              S)
    assert bool(torch.isfinite(rays).all())
    n_sl = fused_train.slice_rows(R, S)
    s0 = np.arange(n_sl) * 16
    started_before = (s0 // S) * S < s0
    assert np.array_equal(torch.isfinite(slices).all(1).numpy(),
                          started_before)


@pytest.mark.parametrize("R,S", [(7, 96), (3, 200)])
def test_fold_plain_rounds_the_fixed_order_sum(R, S):
    """``fold_ray_sums_plain`` on the sectioned spans (s | t | v) is the
    fixed-order sum rounded to bf16, section by section."""
    nb, nt, W = 2, 1, 8
    C = (nb + nt + 1) * W
    g = _dyadic(R, S, C, seed=3)
    rays, slices = fused_train.ray_sums_plain(g, R, S)

    def flat(x):
        return torch.cat([x[:, :nb * W].reshape(-1),
                          x[:, nb * W:(nb + nt) * W].reshape(-1),
                          x[:, (nb + nt) * W:].reshape(-1)])

    d_s, d_t, d_v = fused_train.fold_ray_sums_plain(flat(rays), flat(slices),
                                                    R, S, nb, nt, W)
    want = g.view(R, S, C).sum(1).to(torch.bfloat16)
    assert torch.equal(d_s, want[:, :nb * W].reshape(R, nb, W))
    assert torch.equal(d_t, want[:, nb * W:(nb + nt) * W].reshape(R, nt, W))
    assert torch.equal(d_v, want[:, (nb + nt) * W:])
