"""The trunk kernels' weight layout, on the CPU: ``wgmma_pack`` puts each
element where the kernels' shared-memory operand layout (K-major, 128-byte
swizzle, 64-deep K slices) has it, ``wgmma_unpack`` inverts it bit for
bit for every trunk operand of ``flatten_params`` at W=256 (the forward's
W^T and the dx chain's W), and ``pack_trunk_weights_plain`` lays them out
in the order and size ``csrc/train_fused.cu::pack_trunk_weights`` uses.
The CUDA packer itself is held against this plain version on the card
(``chip_smoke.py``, phase 2). Everything here is exact: a layout moves
bits, it rounds nothing."""

import numpy as np
import pytest
import torch

from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.ops import fused_train

CFG = NetConfig()          # srncar_fused.json widths: W=256, 3 + 1 blocks


@pytest.fixture(scope="module")
def wops():
    gen = torch.Generator().manual_seed(0)
    model = CodeNeRF(CFG, generator=gen).requires_grad_(False)
    return fused_train.kernel_operands(fused_train.flatten_params(model, CFG))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int16).numpy()


def test_pack_puts_each_element_at_its_swizzled_address():
    """Against the layout written out element by element: B[n][k] at byte
    (k // 64)·N·128 + n·128 + ((k % 64) // 8 ^ n % 8)·16 + (k % 8)·2."""
    N, K = 24, 192
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(
        torch.bfloat16)
    want = np.zeros(N * K, np.int16)
    src = _bits(b)
    for n in range(N):
        for k in range(K):
            byte = ((k // 64) * N * 128 + n * 128
                    + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2)
            want[byte // 2] = src[n, k]
    np.testing.assert_array_equal(_bits(fused_train.wgmma_pack(b)), want)


@pytest.mark.parametrize("layer", range(len(fused_train.trunk_layer_indices(
    CFG))))
def test_pack_unpack_round_trip(wops, layer):
    """Every trunk operand, in both of the layouts the kernels read."""
    w = wops[2 * fused_train.trunk_layer_indices(CFG)[layer]]
    assert w.dtype == torch.bfloat16 and w.dim() == 2
    for b in (w.T.contiguous(), w):
        if layer == 0 and b is w:
            continue          # enc_xyz has no dx-chain operand
        packed = fused_train.wgmma_pack(b)
        assert packed.shape == (b.numel(),)
        back = fused_train.wgmma_unpack(packed, *b.shape)
        np.testing.assert_array_equal(_bits(back), _bits(b))
        assert not np.array_equal(_bits(packed), _bits(b.reshape(-1)))


def test_trunk_pack_order_and_size(wops):
    """The forward's operands (W^T, forward order), then the dx chain's
    (W, every layer but enc_xyz): 64·W + 2·((nb + nt + 2)·W² + W²/2)
    elements, as the CUDA side sizes it."""
    W, nb, nt = CFG.W, CFG.shape_blocks, CFG.texture_blocks
    flat = fused_train.pack_trunk_weights_plain(CFG, wops)
    body = (nb + nt + 2) * W * W + W * W // 2
    assert flat.numel() == 64 * W + 2 * body
    ws = [wops[2 * i] for i in fused_train.trunk_layer_indices(CFG)]
    names = [fused_train.weight_shapes(CFG)[i][0]
             for i in fused_train.trunk_layer_indices(CFG)]
    assert names == ["enc_xyz", "shape_0", "shape_1", "shape_2",
                     "enc_shape", "enc_viewdir_pt", "texture_0",
                     "rgb_hidden"]
    off = 0
    for b in [w.T.contiguous() for w in ws] + ws[1:]:
        part = flat[off:off + b.numel()]
        np.testing.assert_array_equal(
            _bits(fused_train.wgmma_unpack(part, *b.shape)), _bits(b))
        off += b.numel()
    assert off == flat.numel()


def test_pack_refuses_untileable_shapes():
    with pytest.raises(ValueError, match="K % 64"):
        fused_train.wgmma_pack(torch.zeros(8, 48, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA operands"):
        fused_train.pack_trunk_weights(CFG, [torch.zeros(1)])
