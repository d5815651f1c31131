"""Card-only: each CUDA kernel of the port against its plain PyTorch
version, at small shapes, in fp32 (tolerance 1e-5 for attention, 1e-4
for the GEMM and GEMV: the same products summed in another order). The
MLA kernel computes in fp32 from bf16 pools too (tolerance 1e-5 in both
pool dtypes); the flash kernel rounds P and its output to bf16, held
to `rounding_bound`, which scales with each output. The bf16 grouped
GEMM (tensor cores) is held to `_gemm_bound`: fp32 sums of exact bf16
products in another order, then one bf16 rounding of the output.

Skips where there is no CUDA device. Imports nothing of JAX, so it also
runs on the machine with the card, which has none:

  python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.expert_gemv import expert_ffn_gemv
from repro_torch.kernels.expert_gemv.ref import expert_ffn_gemv_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, rounding_bound
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.moe_gemm.ref import join_panels, moe_gemm_ref
from repro_torch.kernels.paged_attention import (
    paged_decode_mla,
    paged_decode_mla_ref,
    paged_prefill_gqa,
    paged_prefill_gqa_ref,
    paged_prefill_mla,
    paged_prefill_mla_ref,
)


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


def _gemm_bound(x, w, te, bm):
    """Elementwise bound on |bf16 kernel - moe_gemm_ref|: both sides sum
    the same exact bf16 products in fp32 in another order, at most K fp32
    roundings of the sum of |products| apart, then each rounds to bf16,
    at most one ulp <= eps * |out| apart."""
    k = x.shape[1]
    ref = moe_gemm_ref(x, w, te, bm).float()
    mag = moe_gemm_ref(x.float().abs(), join_panels(w).float().abs(), te, bm)
    return (torch.finfo(torch.bfloat16).eps * ref.abs()
            + k * torch.finfo(torch.float32).eps * mag)


def _bf16_weight(rng, layout, e, k, n, dev):
    """A bf16 weight operand [E, K, N] stored as the serving path stores
    it: row-major [K, N] (MN-major), [N, K] transposed (K-major, the
    down GEMM's view), or the gate|up pair of a [E, 3, K, F] buffer, F
    the largest multiple of 64 columns <= N / 2 (N = 2F)."""
    if layout == "mn_major":
        return _t(rng.normal(size=(e, k, n)), dev, torch.bfloat16)
    if layout == "k_major":
        return _t(rng.normal(size=(e, n, k)), dev, torch.bfloat16).transpose(1, 2)
    buf = _t(rng.normal(size=(e, 3, k, n // 128 * 64)), dev, torch.bfloat16)
    return buf[:, 0], buf[:, 1]


@pytest.mark.parametrize("layout", ["mn_major", "k_major", "pair"])
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("tiles,k,n", [
    (6, 200, 136),    # K, N multiples of 8, not of a tile (the pair: N = 128); 64-wide
    (12, 200, 1408),  # blocks. Here >= 132 blocks at 128 wide; one spans the pair's halves
])
def test_moe_gemm_bf16_kernel_matches_plain(cuda_device, layout, bm, tiles, k, n):
    dev = cuda_device
    rng = np.random.default_rng(6)
    te = _t(([2, 0, 0, 1, 2, 2] * 2)[:tiles], dev, torch.int32)  # 3 experts, uneven groups
    x = _t(rng.normal(size=(tiles * bm, k)), dev, torch.bfloat16)
    w = _bf16_weight(rng, layout, 3, k, n, dev)
    got = moe_gemm(x, w, te, bm=bm, backend="cuda")
    want = moe_gemm_ref(x, w, te, bm)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert ((got.float() - want.float()).abs() <= _gemm_bound(x, w, te, bm)).all()


def test_moe_gemm_bf16_refuses_what_tma_cannot_address(cuda_device):
    dev = cuda_device
    te = _t([0, 1], dev, torch.int32)
    x = torch.ones(256, 64, dtype=torch.bfloat16, device=dev)
    odd = torch.ones(2, 64, 12, dtype=torch.bfloat16, device=dev)  # rows of 24 bytes
    with pytest.raises(ValueError, match="multiples of 16"):
        moe_gemm(x, odd, te, backend="cuda")
    wide = torch.ones(2, 64, 72, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        moe_gemm(x, wide[:, :, 1:65], te, backend="cuda")  # base 2 bytes off
    buf = torch.ones(2, 3, 64, 48, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="pair panel"):
        moe_gemm(x, (buf[:, 0], buf[:, 1]), te, backend="cuda")  # half 48 < 64
    with pytest.raises(ValueError, match="aligned"):
        moe_gemm(torch.ones(256, 60, dtype=torch.bfloat16, device=dev),
                 torch.ones(2, 60, 64, dtype=torch.bfloat16, device=dev), te,
                 backend="cuda")  # x rows of 120 bytes


def test_expert_gemv_kernel_matches_plain(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(2)
    buf = _t(rng.normal(size=(3, 3, 64, 128)) * 0.1, dev)  # a tier buffer
    x = _t(rng.normal(size=(3, 10, 64)), dev)  # 10 tokens: two token passes
    w1, w3, w2 = buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)
    torch.testing.assert_close(expert_ffn_gemv(x, w1, w3, w2, backend="cuda"),
                               expert_ffn_gemv_ref(x, w1, w3, w2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h", [(1, 16), (5, 7), (8, 40)])  # 7, 40: ragged row tiles
def test_paged_mla_kernel_matches_plain(cuda_device, pool_dtype, c, h):
    dev = cuda_device
    rng = np.random.default_rng(4)
    b, r, rd, bs, nb = 4, 64, 16, 4, 5
    n_blocks = b * nb + 2
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb)
    tables[1] = n_blocks  # a dead row: all-trash table
    tables = _t(tables, dev, torch.int32)
    past = _t([0, 3, 11, 20 - c], dev, torch.int32)
    lengths = _t([c, 0, max(1, c // 2), c], dev, torch.int32)  # row 1 all pad
    ql = _t(rng.normal(size=(b, c, h, r)), dev)
    qr = _t(rng.normal(size=(b, c, h, rd)), dev)
    pc = _t(rng.normal(size=(n_blocks + 1, bs, r)), dev, pool_dtype)
    pr = _t(rng.normal(size=(n_blocks + 1, bs, rd)), dev, pool_dtype)
    scale = 0.1
    got = paged_prefill_mla(ql, qr, pc, pr, tables, past, lengths, scale=scale,
                            backend="cuda")
    want = paged_prefill_mla_ref(ql, qr, pc, pr, tables, past, lengths, scale=scale)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    real = torch.arange(c, device=dev)[None, :] < lengths[:, None]
    torch.testing.assert_close(got[real], want[real], atol=1e-5, rtol=1e-5)
    if c == 1:
        dec = paged_decode_mla(ql[:, 0], qr[:, 0], pc, pr, tables, past, scale=scale,
                               backend="cuda")
        torch.testing.assert_close(dec, got[:, 0], atol=0, rtol=0)
        torch.testing.assert_close(
            dec[[0, 2, 3]],
            paged_decode_mla_ref(ql[:, 0], qr[:, 0], pc, pr, tables, past,
                                 scale=scale)[[0, 2, 3]], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk,dh", [
    (True, 100, 100, 64),   # ragged: 100 is no multiple of a tile
    (True, 37, 130, 128),   # fewer queries than keys
    (False, 70, 45, 32),
])
def test_flash_kernel_matches_plain(cuda_device, dtype, causal, sq, sk, dh):
    dev = cuda_device
    rng = np.random.default_rng(5)
    q = _t(rng.normal(size=(3, sq, dh)), dev, dtype)
    k = _t(rng.normal(size=(3, sk, dh)), dev, dtype)
    v = _t(rng.normal(size=(3, sk, dh)), dev, dtype)
    got = flash_attention(q, k, v, causal=causal, backend="cuda")
    want = attention_ref(q[None], k[None], v[None], causal=causal)[0]
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        bound = rounding_bound(q[None], k[None], v[None], causal=causal)[0]
        assert ((got.float() - want.float()).abs() <= bound).all()


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal,sq,sk", [
    (True, 300, 300),   # three 128-row query tiles, the last ragged
    (True, 129, 700),   # a second query tile of one row; six key tiles
    (False, 200, 333),
])
def test_flash_bf16_kernel_over_key_tiles(cuda_device, dh, causal, sq, sk):
    dev = cuda_device
    rng = np.random.default_rng(8)
    q = _t(rng.normal(size=(2, sq, dh)), dev, torch.bfloat16)
    k = _t(rng.normal(size=(2, sk, dh)), dev, torch.bfloat16)
    v = _t(rng.normal(size=(2, sk, dh)), dev, torch.bfloat16)
    got = flash_attention(q, k, v, causal=causal, backend="cuda")
    want = attention_ref(q[None], k[None], v[None], causal=causal)[0]
    bound = rounding_bound(q[None], k[None], v[None], causal=causal)[0]
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert ((got.float() - want.float()).abs() <= bound).all()
    with pytest.raises(ValueError, match="head width"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous(), causal=causal, backend="cuda")
