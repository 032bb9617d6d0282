"""The frozen operation and byte arithmetic against the bound column of
the port's kernel table (``PERF.md``), at the cars widths."""

import pytest

from portbench.harness import arith

NET = {"shape_blocks": 3, "texture_blocks": 1, "W": 256, "num_xyz_freq": 10,
       "num_dir_freq": 4, "latent_dim": 256}


@pytest.mark.parametrize("name, got, want", [
    ("1b single pass, weight gradients, 16,384 x 96",
     lambda: arith.single_pass_bound(NET, 16384, 96, True), 4.1690),
    ("1e dual lanes, weight gradients, 16,384 x 64",
     lambda: arith.single_pass_bound(NET, 16384, 64, True, dual=True), 2.7794),
    ("1a frozen, 4096 x 96",
     lambda: arith.single_pass_bound(NET, 4096, 96, False), 0.6905),
    ("3a sigma only, 16,384 x 32",
     lambda: arith.sigma_bound(NET, 16384, 32), 0.2953),
    ("trunk_fwd_kernel in training, 16,384 x 96",
     lambda: arith.trunk_fwd_bound(NET, 16384 * 96, True), 1.9550),
    ("trunk_dx_kernel in training, 16,384 x 96",
     lambda: arith.trunk_dx_bound(NET, 16384 * 96, True), 1.8949),
    ("wgrad_kernel, 16,384 x 96",
     lambda: arith.wgrad_bound(NET, 16384 * 96), 3.5458),
])
def test_bound_column(name, got, want):
    assert round(got(), 4) == pytest.approx(want, abs=1e-4), name


def test_model_flops():
    # forward 884,736, input cotangents 851,968 FLOP a point at W = 256
    assert arith.trunk_flops_per_point(NET) == 884_736
    assert arith.dx_flops_per_point(NET) == 851_968
    assert arith.sigma_flops_per_point(NET) == 557_056
    assert arith.train_step_flops(NET, 16384, 96) == \
        (2 * 884_736 + 851_968) * 16384 * 96
    assert arith.render_flops(NET, 16384, 96) == 884_736 * 16384 * 96
