"""The bf16 grouped GEMM's host-side layout logic, on the CPU: how
`tma_weight_map` turns a weight operand's strides into the 4-D tensor
map the kernel reads (dims innermost first, byte strides, K- or
MN-major B), what it refuses, and `pick_bn`'s block width. The kernel
itself runs only on the card (tests/test_torch_cuda_kernels.py)."""
import pytest
import torch

from repro_torch.kernels.moe_gemm.kernel import pick_bn, tma_weight_map, weight_layout


def _buf(n, d, f):
    """A tier buffer [n, 3, D, F] in bf16: gate, up, down per slot."""
    return torch.zeros(n, 3, d, f, dtype=torch.bfloat16)


def test_gate_up_pair_is_mn_major_with_a_half_dimension():
    n, d, f = 4, 256, 192
    buf = _buf(n, d, f)
    k_major, dims, strides = tma_weight_map(weight_layout((buf[:, 0], buf[:, 1]), d))
    assert not k_major
    assert dims == (f, d, 2, n)  # (n within a half, K, half, expert)
    assert strides == (f * 2, d * f * 2, 3 * d * f * 2)


def test_transposed_down_view_is_k_major():
    n, d, f = 4, 256, 192
    w2 = _buf(n, d, f)[:, 2].transpose(1, 2)  # stored [D, F], read as [F, D]
    k_major, dims, strides = tma_weight_map(weight_layout(w2, f))
    assert k_major
    assert dims == (f, d, 1, n)  # (K, N, one half, expert)
    assert strides == (f * 2, 3 * d * f * 2, 3 * d * f * 2)


def test_contiguous_weight_is_mn_major_in_one_half():
    w = torch.zeros(3, 200, 136, dtype=torch.bfloat16)
    k_major, dims, strides = tma_weight_map(weight_layout(w, 200))
    assert not k_major
    assert dims == (136, 200, 1, 3)
    assert strides == (136 * 2, 200 * 136 * 2, 200 * 136 * 2)


def test_refuses_what_tma_cannot_address():
    with pytest.raises(ValueError, match="multiples of 16"):  # rows of 24 bytes
        tma_weight_map(weight_layout(torch.zeros(2, 64, 12, dtype=torch.bfloat16), 64))
    wide = torch.zeros(2, 64, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):  # base 2 bytes off
        tma_weight_map(weight_layout(wide[:, :, 1:65], 64))
    buf = _buf(2, 64, 48)
    with pytest.raises(ValueError, match="pair panel"):  # half of 48 columns
        tma_weight_map(weight_layout((buf[:, 0], buf[:, 1]), 64))
    with pytest.raises(ValueError, match="no unit stride"):  # every other column
        tma_weight_map(weight_layout(wide[:, :, ::2], 64))


@pytest.mark.parametrize("m_blocks,n,bn", [
    (8, 1024, 64),    # granite hot tier: 64 blocks at 128 wide would idle half the SMs
    (25, 3072, 128),  # deepseek gate|up: 600 blocks
    (25, 5120, 128),  # deepseek down: 1000 blocks
    (12, 1408, 128),  # exactly 132 blocks at 128 wide
    (12, 1280, 64),   # 120 blocks at 128 wide
])
def test_pick_bn_fills_the_card(m_blocks, n, bn):
    assert pick_bn(m_blocks, n, n_sm=132) == bn
