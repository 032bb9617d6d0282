"""trunk_fwd_kernel's plane stores at their edges.

The forward's planes leave the kernel's tile by TMA bulk tensor stores,
whose tensor maps clip the rows past P = R·S. On the card (skipped
without one), at a ragged ray count (R = 37, so the last 128-point tile
is cut; at S = 64 its second row half lies wholly past P, and at S = 24
the tile's rays outgrow the stage and the epilogue reads them from device
memory), every tensor the wrappers allocate gets canary bytes past its
end; a forward must leave them, store every plane as its plain version
computes it (``chip_smoke._close``, the phase-2 bars), and count the
planes it stored in its wrapper's ``bulk_planes``. The wrappers take
multiples of 16 rays (the JAX package's ray-count rule), which the test
lifts: the kernels themselves take any R.
"""

from __future__ import annotations

import ctypes
import math

import pytest
import torch

import chip_smoke
from codenerf_tpu_torch.ops import fused_mlp, fused_train

R = 37
CANARY = 0x5A


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: trunk_fwd_kernel runs only there")
    return torch.device("cuda")


class Canaried:
    """``torch.empty`` with canary bytes after each tensor's end (64 rows
    of the widest f32 plane), the tensors recorded in allocation order."""

    TAIL = 64 * 256 * 4

    def __init__(self):
        self.real = torch.empty
        self.made = []

    def __call__(self, *shape, dtype=None, device=None, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list,
                                                     torch.Size)):
            shape = tuple(shape[0])
        dtype = dtype or torch.get_default_dtype()
        size = torch.tensor([], dtype=dtype).element_size()
        nbytes = math.prod(shape) * size
        buf = self.real(nbytes + self.TAIL, dtype=torch.uint8, device=device,
                        **kw).fill_(CANARY)
        x = buf[:nbytes].view(dtype).view(shape)
        self.made.append((x, buf, nbytes))
        return x

    def intact(self) -> bool:
        return all(bool((buf[n:] == CANARY).all())
                   for _, buf, n in self.made)

    def first(self, dtype, numel: int) -> torch.Tensor:
        return next(x for x, _, _ in self.made
                    if x.dtype == dtype and x.numel() == numel)


def _canaried(monkeypatch, fn):
    """``fn()`` with canaried allocations and any ray count; returns its
    result and the allocations."""
    alloc = Canaried()
    with monkeypatch.context() as m:
        m.setattr(fused_train, "single_pass_available", lambda cfg, n: True)
        m.setattr(torch, "empty", alloc)
        out = fn()
        torch.cuda.synchronize()
    return out, alloc


def _planes_match(pairs) -> None:
    failed = [name for name, got, want in pairs
              if not chip_smoke._close(name, got, want)[1]]
    assert not failed, failed


@pytest.mark.parametrize("S", [96, 64, 24])
def test_card_served_forwards_store_within_p(card, monkeypatch, S):
    cfg, args = chip_smoke.kernel_inputs(card, R, S)
    ro8, vd8, z, sproj, tproj, vcontrib = args[5:11]
    trunk = args[-1]
    fargs = (cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib, trunk)
    P, W, nb, nt = R * S, cfg.W, cfg.shape_blocks, cfg.texture_blocks
    lib = fused_train.library()
    bulk = (fused_mlp.planes_fwd.bulk_planes["planes"],
            fused_mlp.sigma_fwd.bulk_planes["sigma"])

    planes, alloc = _canaried(monkeypatch,
                              lambda: fused_mlp.planes_fwd(*fargs))
    assert alloc.intact()
    ws = alloc.first(torch.bfloat16, lib.forward_workspace(R, S, W, nb, nt,
                                                           1))
    sigma, alloc_s = _canaried(monkeypatch,
                               lambda: fused_mlp.sigma_fwd(*fargs))
    assert alloc_s.intact()
    ws_s = alloc_s.first(torch.bfloat16, lib.forward_workspace(R, S, W, nb,
                                                               nt, 0))
    assert fused_mlp.planes_fwd.bulk_planes["planes"] - bulk[0] == 2
    assert fused_mlp.sigma_fwd.bulk_planes["sigma"] - bulk[1] == 1

    acts = fused_mlp.forward_plain(cfg, R, S, ro8, vd8, z, sproj, tproj,
                                   vcontrib, trunk.wops)
    t, r = ws[:P * W].view(P, W), ws[P * W:].view(P, W // 2)
    _planes_match([("t", t, acts["t"]), ("r", r, acts["r"])])
    # The coarse pass's t is the planes' t, bit for bit, whether either
    # forward staged its rays' rows or read them from device memory.
    assert torch.equal(ws_s.view(P, W), t)
    want = fused_mlp.planes_fwd_plain(*fargs)
    failed = [n for n, g, w_ in zip(("sigma", "r", "g", "b"), planes, want)
              if not chip_smoke._close(n, g, w_, per_ray=True)[1]]
    assert not failed, failed
    if S == 64:
        assert torch.equal(sigma, planes[0])


@pytest.mark.parametrize("S", [96, 64, 24])
def test_card_training_forward_stores_within_p(card, monkeypatch, S):
    cfg, args = chip_smoke.kernel_inputs(card, R, S)
    ro8, vd8, z, sproj, tproj, vcontrib = args[5:11]
    P, W, nb, nt = R * S, cfg.W, cfg.shape_blocks, cfg.texture_blocks
    before = fused_train.train_fused.bulk_planes["train"]

    _, alloc = _canaried(monkeypatch, lambda: fused_train.train_fused(
        *args, weight_grads=True))
    assert alloc.intact()
    stored = fused_train.train_fused.bulk_planes["train"] - before
    assert stored == nb + nt + 5

    # fused_step's workspace: t, r, the rgb_hidden cotangent, then the
    # PE, the shape blocks' inputs, the last shape block's output, the
    # texture blocks' inputs and the last texture block's output.
    ws = next(x for x, _, _ in alloc.made if x.dtype == torch.bfloat16)
    at = 0

    def take(planes, cols):
        nonlocal at
        x = ws[at:at + planes * P * cols].view(planes, P, cols)
        at += planes * P * cols
        return x

    t, r, _ = take(1, W)[0], take(1, W // 2)[0], take(1, W // 2)
    pe, xs, ys_last = take(1, 64)[0], take(nb, W), take(1, W)[0]
    xt, yts_last = take(nt, W), take(1, W)[0]
    acts = fused_mlp.forward_plain(cfg, R, S, ro8, vd8, z, sproj, tproj,
                                   vcontrib, args[-1].wops)
    _planes_match(
        [("pe", pe, acts["pe"]), ("t", t, acts["t"]), ("r", r, acts["r"]),
         ("ys_last", ys_last, acts["ys"][-1]),
         ("yts_last", yts_last, acts["yts"][-1])]
        + [(f"xs[{j}]", xs[j], acts["xs"][j]) for j in range(nb)]
        + [(f"xt[{k}]", xt[k], acts["xts"][k]) for k in range(nt)])


def test_bulk_planes_counters_follow_the_launch_modes():
    """Each forward wrapper counts the planes stored by TMA per mode, beside
    its launches; the library binds the query as an int."""
    for fn in (fused_train.train_fused, fused_train.plane_bwd,
               fused_mlp.sigma_fwd, fused_mlp.planes_fwd):
        assert set(fn.bulk_planes) == set(fn.launches)

    class Lib:
        def __getattr__(self, name):
            f = type("Fn", (), {})()
            setattr(self, name, f)
            return f

    lib = Lib()
    fused_train._bind(lib)
    assert lib.forward_bulk_planes.argtypes == []
    assert lib.forward_bulk_planes.restype is ctypes.c_int
