"""Card-only: each CUDA kernel of the port against its plain PyTorch
version, at small shapes, in fp32 (tolerance 1e-5 for attention, 1e-4
for the GEMM and GEMV: the same products summed in another order).

Skips where there is no CUDA device. Imports nothing of JAX, so it also
runs on the machine with the card, which has none:

  python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.expert_gemv import expert_ffn_gemv
from repro_torch.kernels.expert_gemv.ref import expert_ffn_gemv_ref
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.paged_attention import paged_prefill_gqa, paged_prefill_gqa_ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): the kernels build and run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.tensor(a, dtype=dtype, device=dev)


def test_paged_attention_kernel_matches_plain(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(0)
    b, c, kv, g, hd, bs, nb = 3, 4, 2, 2, 64, 4, 4
    tables = _t(rng.permutation(b * nb + 2)[: b * nb].reshape(b, nb), dev, torch.int32)
    past = _t([0, 5, 12], dev, torch.int32)
    lengths = _t([4, 2, 0], dev, torch.int32)  # row 2 is all pad
    q = _t(rng.normal(size=(b, c, kv, g, hd)), dev)
    pk, pv = (_t(rng.normal(size=(b * nb + 3, bs, kv, hd)), dev) for _ in range(2))
    got = paged_prefill_gqa(q, pk, pv, tables, past, lengths, backend="cuda")
    want = paged_prefill_gqa_ref(q, pk, pv, tables, past, lengths)
    assert torch.isfinite(got).all()
    real = torch.arange(c, device=dev)[None, :] < lengths[:, None]
    torch.testing.assert_close(got[real], want[real], atol=1e-5, rtol=1e-5)


def test_moe_gemm_kernel_matches_plain(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(1)
    te = _t([1, 0, 1], dev, torch.int32)  # uneven groups, 128-row tiles
    x = _t(rng.normal(size=(384, 96)), dev)
    w = _t(rng.normal(size=(2, 96, 80)), dev)  # ragged N and K edges
    torch.testing.assert_close(moe_gemm(x, w, te, backend="cuda"), moe_gemm_ref(x, w, te),
                               atol=1e-4, rtol=1e-4)


def test_moe_gemm_kernel_matches_plain_on_panel_pair(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(3)
    te = _t([0, 1], dev, torch.int32)
    x = _t(rng.normal(size=(256, 64)), dev)
    buf = _t(rng.normal(size=(2, 3, 64, 48)), dev)  # a tier buffer [n, 3, K, F]
    pair = (buf[:, 0], buf[:, 1])
    torch.testing.assert_close(moe_gemm(x, pair, te, backend="cuda"),
                               moe_gemm_ref(x, pair, te), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="weight panel"):
        moe_gemm(x[:, :32].contiguous(), pair, te, backend="cuda")  # K 32 != 64


def test_expert_gemv_kernel_matches_plain(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(2)
    buf = _t(rng.normal(size=(3, 3, 64, 128)) * 0.1, dev)  # a tier buffer
    x = _t(rng.normal(size=(3, 10, 64)), dev)  # 10 tokens: two token passes
    w1, w3, w2 = buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)
    torch.testing.assert_close(expert_ffn_gemv(x, w1, w3, w2, backend="cuda"),
                               expert_ffn_gemv_ref(x, w1, w3, w2), atol=1e-4, rtol=1e-4)
