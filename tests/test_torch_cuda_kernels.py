"""Card-only: each CUDA kernel of the port against its plain PyTorch
version, at small shapes, in fp32 (tolerance 1e-5 for attention, 1e-4
for the GEMM and GEMV: the same products summed in another order). The
bf16 expert GEMV and paged GQA attention (tensor cores) are held per
element, as chip_smoke.py holds them, to their `gemv_rounding_bound` and
`gqa_rounding_bound`: the output, and h or P before it, round to bf16.
The MLA kernel computes in fp32 from bf16 pools too (tolerance 1e-5 in both
pool dtypes): its bf16 path runs on the tensor cores with q as three bf16
terms (all 24 bits of fp32) and P as two (16 bits, the one bf16 rounding
the output sees), each product of a term with a bf16 latent exact in fp32
and summed in fp32 (one bf16 rounding of q and P would miss 1e-5 by a
factor of hundreds, tests/test_torch_mla_split.py); the flash kernel rounds P and its output to bf16, held
to `rounding_bound`, which scales with each output. The bf16 grouped
GEMM (tensor cores) is held to `_gemm_bound`: fp32 sums of exact bf16
products in another order, then one bf16 rounding of the output. The
gradient of the GEMM's kernel route (forward and dX on the kernel, dW by
bmm) is held to the plain route's autograd: fp32 at 1e-4, and the bf16
SwiGLU FFN's output and gradients per element to `grad_rounding_bound`.

Skips where there is no CUDA device. Imports nothing of JAX, so it also
runs on the machine with the card, which has none:

  python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.expert_gemv import (
    cold_expert_ffn,
    expert_ffn_gemv,
    gemv_rounding_bound,
)
from repro_torch.kernels.expert_gemv.ref import expert_ffn_gemv_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, rounding_bound
from repro_torch.kernels.moe_gemm import grouped_expert_ffn, moe_gemm
from repro_torch.kernels.moe_gemm.ref import grad_rounding_bound, join_panels, moe_gemm_ref
from repro_torch.kernels.paged_attention import (
    gqa_rounding_bound,
    paged_decode_gqa,
    paged_decode_mla,
    paged_decode_mla_ref,
    paged_prefill_gqa,
    paged_prefill_gqa_ref,
    paged_prefill_mla,
    paged_prefill_mla_ref,
)
from repro_torch.kernels.paged_attention.kernel import _launch as gqa_launch
from repro_torch.kernels.paged_attention.kernel import _launch_mla as mla_launch


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


def _f32_deepseek_tier(rng, dev, t, n_slots=3, d=5120, f=1536):
    """fp32 tokens [n_slots, t, d] and the gate, up and transposed down
    views of a [n_slots, 3, d, f] tier buffer at deepseek-v2's widths."""
    buf = _t(rng.normal(size=(n_slots, 3, d, f)) * d ** -0.5, dev)
    x = _t(rng.normal(size=(n_slots, t, d)), dev)
    return x, buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)


@pytest.mark.parametrize("t", [11, 32, 40])
def test_expert_gemv_f32_takes_any_tokens_at_deepseek_widths(cuda_device, t):
    """fp32 at D = 5120, F = 1536: a slot of more tokens than shared
    memory holds at once (10) runs group by group in one call, at 1e-5."""
    x, w1, w3, w2 = _f32_deepseek_tier(np.random.default_rng(40 + t), cuda_device, t)
    got = expert_ffn_gemv(x, w1, w3, w2, backend="cuda")
    torch.testing.assert_close(got, expert_ffn_gemv_ref(x, w1, w3, w2), atol=1e-5, rtol=1e-5)


def test_expert_gemv_f32_token_groups_do_not_change_a_tokens_bits(cuda_device):
    """The first 10 tokens of a 40-token call (four groups) equal, bitwise,
    a 10-token call on the same slots (one group)."""
    x, w1, w3, w2 = _f32_deepseek_tier(np.random.default_rng(7), cuda_device, 40)
    long = expert_ffn_gemv(x, w1, w3, w2, backend="cuda")
    short = expert_ffn_gemv(x[:, :10].contiguous(), w1, w3, w2, backend="cuda")
    assert torch.equal(long[:, :10], short)


def _tier_case(rng, dev, n_slots, t, d, f, live, zero_rows=()):
    """bf16 token buffers [n_slots, t, d] (slots not in `live` all zero,
    rows `zero_rows` of the live slots zero) and the gate, up and
    transposed down views of a [n_slots, 3, d, f] tier buffer."""
    buf = _t(rng.normal(size=(n_slots, 3, d, f)) * d ** -0.5, dev, torch.bfloat16)
    x = np.zeros((n_slots, t, d))
    x[list(live)] = rng.normal(size=(len(live), t, d))
    for r in zero_rows:
        x[list(live), r] = 0.0
    return _t(x, dev, torch.bfloat16), buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)


@pytest.mark.parametrize("n_slots,t,d,f,live,zero_rows", [
    (6, 1, 256, 128, (0, 3), ()),
    (5, 4, 1024, 512, (1, 2, 4), (3,)),       # granite widths
    (9, 6, 384, 200, (0, 8), (0, 5)),         # F off the panel: the ops pad it
    (3, 11, 512, 256, (0, 1, 2), (2, 10)),    # two n tiles, every slot live
    (4, 16, 5120, 256, (1, 3), (15,)),        # 16 tokens at deepseek's d_model
    (2, 32, 128, 64, (0,), (7,)),             # one full group of 32 tokens
    (3, 33, 256, 128, (0, 2), (32,)),         # a second group of one token, zero in
    (2, 49, 1024, 512, (1,), (0, 40)),        # granite widths, two groups
])
def test_expert_gemv_bf16_skips_empty_slots(cuda_device, n_slots, t, d, f, live, zero_rows):
    dev = cuda_device
    rng = np.random.default_rng(20 + t)
    x, w1, w3, w2 = _tier_case(rng, dev, n_slots, t, d, f, live, zero_rows)
    got = cold_expert_ffn(x, w1, w3, w2, backend="cuda")
    want = cold_expert_ffn(x, w1, w3, w2, backend="ref")
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    empty = [e for e in range(n_slots) if e not in live]
    assert (got[empty] == 0).all()  # skipped slots: exactly zero
    for r in zero_rows:
        assert (got[list(live), r] == 0).all()  # zero rows of live slots too
    bound = gemv_rounding_bound(x, w1, w3, w2)
    assert ((got.float() - want.float()).abs() <= bound).all()
    for e in live:  # a slot's output does not depend on the other slots
        alone = torch.zeros_like(x)
        alone[e] = x[e]
        assert torch.equal(cold_expert_ffn(alone, w1, w3, w2, backend="cuda")[e], got[e])


def test_expert_gemv_bf16_refuses_what_it_cannot_address(cuda_device):
    dev = cuda_device
    x = torch.ones(2, 4, 64, dtype=torch.bfloat16, device=dev)
    w = torch.ones(2, 64, 32, dtype=torch.bfloat16, device=dev)
    # W2 [E, F, D] with unit stride along neither F nor D
    w2 = torch.ones(2, 32, 128, dtype=torch.bfloat16, device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="unit stride"):
        expert_ffn_gemv(x, w, w, w2, backend="cuda")
    w_odd = torch.ones(2, 64, 36, dtype=torch.bfloat16, device=dev)  # F off the granule
    with pytest.raises(ValueError, match="multiples of 8"):
        cold_expert_ffn(x, w_odd, w_odd, w_odd.transpose(1, 2), backend="cuda")


def _gqa_case(rng, dev, dtype, b, c, g, hd, nb, kv=2, bs=4):
    """Rows: 0 a chunk at past 0; 1 all pad (len 0); 2 dead (len 0, an
    all-trash table); the rest random past / len within the table."""
    n_blocks = b * nb + 2
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb)
    tables[2] = n_blocks  # the trash block
    past = rng.integers(0, nb * bs - c + 1, size=b)
    lengths = rng.integers(1, c + 1, size=b)
    past[0], lengths[1], lengths[2] = 0, 0, 0
    q = _t(rng.normal(size=(b, c, kv, g, hd)), dev, dtype)
    pk, pv = (_t(rng.normal(size=(n_blocks + 1, bs, kv, hd)), dev, dtype) for _ in range(2))
    return (q, pk, pv, _t(tables, dev, torch.int32), _t(past, dev, torch.int32),
            _t(lengths, dev, torch.int32))


@pytest.mark.parametrize("hd", [16, 64, 128])  # 16: the smoke configs' heads
@pytest.mark.parametrize("c,g,nb", [
    (1, 1, 16), (1, 2, 64), (1, 4, 40),    # decode; 64 blocks: two key splits
    (1, 2, 256),                           # 16 key tiles: 8 splits, short rows' empty
    (8, 2, 16), (8, 4, 8), (8, 2, 64),     # a prefill chunk over two key splits
    (32, 1, 16), (32, 2, 24), (32, 4, 16),  # 32 x 4 = 128 rows: two query tiles
])
def test_paged_gqa_bf16_kernel_matches_plain(cuda_device, hd, c, g, nb):
    dev = cuda_device
    rng = np.random.default_rng(30 + c + g + nb)
    args = _gqa_case(rng, dev, torch.bfloat16, b=5, c=c, g=g, hd=hd, nb=nb)
    got = paged_prefill_gqa(*args, backend="cuda")
    want = paged_prefill_gqa_ref(*args)
    lengths = args[-1]
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    real = torch.arange(c, device=dev)[None, :] < lengths[:, None]
    bound = gqa_rounding_bound(*args[:5])
    assert ((got[real].float() - want[real].float()).abs() <= bound[real]).all()
    if nb >= 64:  # split over the keys by default; one split holds the bound too
        one = gqa_launch(*args, splits=1)
        assert ((one[real].float() - want[real].float()).abs() <= bound[real]).all()
    if hd == 64 and nb == 16:
        with pytest.raises(ValueError, match="head width"):
            paged_prefill_gqa(*(t[..., :32].contiguous() for t in args[:3]), *args[3:],
                              backend="cuda")
    if c == 1:  # decode = the chunk of 1 (rows of length 0 walk less there)
        dec = paged_decode_gqa(args[0][:, 0], *args[1:4], args[4], backend="cuda")
        assert torch.isfinite(dec.float()).all()
        assert torch.equal(dec[lengths > 0], got[:, 0][lengths > 0])


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


def _mla_deepseek_case(rng, dev, c, nb, past, lengths):
    """deepseek-v2's widths (H=128, r=512, rd=64) over 4-token blocks in
    bf16, row 1 dead (an all-trash table, length 0)."""
    b, h, r, rd, bs = len(past), 128, 512, 64, 4
    n_blocks = b * nb + 2
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb)
    tables[1] = n_blocks
    return (_t(rng.normal(size=(b, c, h, r)), dev), _t(rng.normal(size=(b, c, h, rd)), dev),
            _t(rng.normal(size=(n_blocks + 1, bs, r)), dev, torch.bfloat16),
            _t(rng.normal(size=(n_blocks + 1, bs, rd)), dev, torch.bfloat16),
            _t(tables, dev, torch.int32), _t(past, dev, torch.int32),
            _t(lengths, dev, torch.int32))


@pytest.mark.parametrize("c,nb,past,lengths", [
    (1, 18, [40, 0, 60, 71], [1, 0, 1, 1]),      # decode, as served (cache_len 72)
    (32, 18, [0, 8, 16, 40], [32, 0, 20, 32]),   # a 32-token chunk; row 2 ragged
    (1, 1024, [3900, 0, 4095, 17], [1, 0, 1, 1]),  # decode over a 4096-key table
])
def test_paged_mla_bf16_kernel_at_deepseek_widths(cuda_device, c, nb, past, lengths):
    dev = cuda_device
    rng = np.random.default_rng(40 + c + nb)
    args = _mla_deepseek_case(rng, dev, c, nb, past, lengths)
    scale = (128 + 64) ** -0.5
    got = paged_prefill_mla(*args, scale=scale, backend="cuda")
    want = paged_prefill_mla_ref(*args, scale=scale)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    real = torch.arange(c, device=dev)[None, :] < args[-1][:, None]
    torch.testing.assert_close(got[real], want[real], atol=1e-5, rtol=1e-5)
    if nb >= 1024:  # split over the keys by default; one split holds 1e-5 too
        one = mla_launch(*args, scale, splits=1)
        torch.testing.assert_close(one[real], want[real], atol=1e-5, rtol=1e-5)
    if c == 1:  # decode = the chunk of 1, bitwise
        dec = paged_decode_mla(args[0][:, 0], args[1][:, 0], *args[2:5], args[5],
                               scale=scale, backend="cuda")
        assert torch.isfinite(dec).all()
        assert torch.equal(dec, got[:, 0])


# a speculative verify chunk: the sampled token and up to k = 4 drafts,
# padded to a width of 8; rows shorter than 8, pasts not block-aligned,
# the last row dead (an all-trash table, length 0)
VERIFY_PAST, VERIFY_LENS = [41, 50, 63, 27, 0], [5, 1, 3, 8, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_gqa_verify_chunk_matches_plain(cuda_device, dtype):
    dev = cuda_device
    rng = np.random.default_rng(50)
    b, c, kv, g, hd, bs, nb = 5, 8, 8, 2, 64, 4, 18
    n_blocks = b * nb + 2
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb)
    tables[-1] = n_blocks
    q = _t(rng.normal(size=(b, c, kv, g, hd)), dev, dtype)
    pk, pv = (_t(rng.normal(size=(n_blocks + 1, bs, kv, hd)), dev, dtype) for _ in range(2))
    args = (q, pk, pv, _t(tables, dev, torch.int32), _t(VERIFY_PAST, dev, torch.int32),
            _t(VERIFY_LENS, dev, torch.int32))
    got = paged_prefill_gqa(*args, backend="cuda")
    want = paged_prefill_gqa_ref(*args)
    assert got.dtype == dtype
    real = torch.arange(c, device=dev)[None, :] < args[-1][:, None]
    assert torch.isfinite(got[real].float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got[real], want[real], atol=1e-5, rtol=1e-5)
    else:
        bound = gqa_rounding_bound(*args[:5])
        assert ((got[real].float() - want[real].float()).abs() <= bound[real]).all()


# --------------------------------------------- jamba-v0.1-52b's kernel shapes
JAMBA_D, JAMBA_F = 4096, 14336  # d_model, d_expert


def _jamba_buffer(dev, dtype, n_slots, seed):
    """A [n_slots, 3, 4096, 14336] tier buffer (gate, up, down transposed),
    drawn on the card: ~0.7-1.8 GB of weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(n_slots, 3, JAMBA_D, JAMBA_F, generator=gen, device=dev)
    return w.mul_(JAMBA_D ** -0.5).to(dtype), gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,g,c,seed", [
    # jamba's attention layer: a decode step and the 64-token bucket
    (8, 4, 1, 71), (8, 4, 64, 134),
    # the dense family: llama3.2-3b / phi4-mini, qwen2.5-32b,
    # chameleon-34b, granite-20b's MQA (a 32-token chunk at G 48: 1536
    # query rows a KV head, 24 row tiles)
    *[(kv, g, c, 90 + g + c) for kv, g in [(8, 3), (8, 5), (8, 8), (1, 48)] for c in (1, 32)],
])
def test_paged_gqa_at_jamba_widths(cuda_device, dtype, kv, g, c, seed):
    """The hd-128 (Kv, G) pairs over 18-block tables: jamba's (8, 4) and
    the dense family's; bf16 held to `gqa_rounding_bound`, fp32 to 1e-5."""
    dev = cuda_device
    args = _gqa_case(np.random.default_rng(seed), dev, dtype, b=5, c=c, g=g, hd=128, nb=18,
                     kv=kv)
    got = paged_prefill_gqa(*args, backend="cuda")
    want = paged_prefill_gqa_ref(*args)
    real = torch.arange(c, device=dev)[None, :] < args[-1][:, None]
    assert got.dtype == dtype and torch.isfinite(got[real].float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got[real], want[real], atol=1e-5, rtol=1e-5)
    else:
        bound = gqa_rounding_bound(*args[:5])
        assert ((got[real].float() - want[real].float()).abs() <= bound[real]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_slots,t,live", [(4, 4, 4), (5, 4, 2), (7, 8, 3)])
def test_expert_gemv_at_jamba_widths(cuda_device, dtype, n_slots, t, live):
    """jamba's decode tiers (D 4096, F 14336: about 9x the F panels a
    slot has at deepseek's widths): hot 4 slots all live, warm 5 with 2
    live, a cold-like 7 with 3 live at 8 tokens. Slots past `live` have
    no tokens; bf16 holds `gemv_rounding_bound` and gives them exactly
    zero, fp32 holds 1e-5."""
    dev = cuda_device
    buf, gen = _jamba_buffer(dev, dtype, n_slots, 80 + n_slots)
    x = torch.randn(n_slots, t, JAMBA_D, generator=gen, device=dev).to(dtype)
    x[live:] = 0
    w1, w3, w2 = buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)
    got = expert_ffn_gemv(x, w1, w3, w2, backend="cuda")
    want = expert_ffn_gemv_ref(x, w1, w3, w2)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert (got[live:] == 0).all()
        bound = gemv_rounding_bound(x, w1, w3, w2)
        assert ((got.float() - want.float()).abs() <= bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", [True, False])
def test_moe_gemm_at_jamba_widths(cuda_device, dtype, pair):
    """A prefill call's hot tier at jamba's widths, 4 slots x 128 rows:
    gate|up (K 4096, N 28672, read as the buffer's panel pair) and down
    (K 14336, N 4096, the stored matrix transposed); bf16 held to
    `_gemm_bound`, fp32 to 1e-4."""
    dev = cuda_device
    buf, gen = _jamba_buffer(dev, dtype, 4, 90 + pair)
    x = torch.randn(4 * 128, JAMBA_D if pair else JAMBA_F, generator=gen, device=dev)
    x = x.to(dtype)
    w = (buf[:, 0], buf[:, 1]) if pair else buf[:, 2].transpose(1, 2)
    te = torch.arange(4, dtype=torch.int32, device=dev)
    got = moe_gemm(x, w, te, backend="cuda")
    want = moe_gemm_ref(x, w, te)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert ((got.float() - want.float()).abs() <= _gemm_bound(x, w, te, 128)).all()


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
def test_paged_mla_verify_chunk_at_deepseek_widths(cuda_device, pool_dtype):
    dev = cuda_device
    rng = np.random.default_rng(51)
    b, c, h, r, rd, bs, nb = 5, 8, 128, 512, 64, 4, 18
    n_blocks = b * nb + 2
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb)
    tables[-1] = n_blocks
    args = (_t(rng.normal(size=(b, c, h, r)), dev), _t(rng.normal(size=(b, c, h, rd)), dev),
            _t(rng.normal(size=(n_blocks + 1, bs, r)), dev, pool_dtype),
            _t(rng.normal(size=(n_blocks + 1, bs, rd)), dev, pool_dtype),
            _t(tables, dev, torch.int32), _t(VERIFY_PAST, dev, torch.int32),
            _t(VERIFY_LENS, dev, torch.int32))
    scale = (128 + 64) ** -0.5
    got = paged_prefill_mla(*args, scale=scale, backend="cuda")
    want = paged_prefill_mla_ref(*args, scale=scale)
    real = torch.arange(c, device=dev)[None, :] < args[-1][:, None]
    assert torch.isfinite(got[real]).all()
    torch.testing.assert_close(got[real], want[real], atol=1e-5, rtol=1e-5)


def test_paged_mla_bf16_refuses_what_it_cannot_address(cuda_device):
    dev = cuda_device
    b, h, bs = 1, 4, 4
    tables = torch.zeros(b, 2, dtype=torch.int32, device=dev)
    past = torch.zeros(b, dtype=torch.int32, device=dev)
    for r, rd in ((60, 8), (64, 12), (64, 72)):  # off the 8-column piece; rope > 64
        args = (torch.zeros(b, 1, h, r, device=dev), torch.zeros(b, 1, h, rd, device=dev),
                torch.zeros(3, bs, r, dtype=torch.bfloat16, device=dev),
                torch.zeros(3, bs, rd, dtype=torch.bfloat16, device=dev), tables, past,
                torch.ones_like(past))
        with pytest.raises(ValueError, match="multiples of 8"):
            paged_prefill_mla(*args, scale=0.1, backend="cuda")


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


def _with_grads(fn, inputs, dy):
    """fn's output and the gradients of <output, dy> with respect to
    each input (fresh leaves)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("groups", ["tiles", "identity", "shared"])
def test_moe_gemm_gradient_matches_plain(cuda_device, groups):
    """fp32 forward, dX and dW of the kernel route against the plain
    route's autograd, with the weight gradient's groups as the GEMM's
    tiles (the default), one group per expert, or two groups per expert
    (the grouped dispatch's [B*E] groups). Forward and dX launch the
    kernel: two launches per call and its backward."""
    dev = cuda_device
    rng = np.random.default_rng(11)
    e, rows, k, n = 3, 256, 96, 80
    ge = {"tiles": None, "identity": None, "shared": [0, 1, 2, 0, 1, 2]}[groups]
    n_groups = e if ge is None else len(ge)
    group_expert = None if ge is None else _t(ge, dev, torch.int32)
    te = (torch.arange(e, dtype=torch.int32, device=dev) if ge is None
          else group_expert).repeat_interleave(rows // 128)
    kw = {} if groups == "tiles" else dict(groups=(rows, group_expert))
    x = _t(rng.normal(size=(n_groups * rows, k)), dev)
    w = _t(rng.normal(size=(e, k, n)), dev)
    dy = _t(rng.normal(size=(n_groups * rows, n)), dev)
    before = moe_gemm.launches
    got = _with_grads(lambda a, b: moe_gemm(a, b, te, backend="cuda", **kw), (x, w), dy)
    torch.cuda.synchronize()
    assert moe_gemm.launches - before == 2
    want = _with_grads(lambda a, b: moe_gemm(a, b, te, backend="ref"), (x, w), dy)
    for name, g, ref in zip(("out", "dx", "dw"), got, want):
        torch.testing.assert_close(g, ref, atol=1e-4, rtol=1e-4, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rows", [1, 2])
def test_grouped_expert_ffn_gradient_matches_plain(cuda_device, dtype, n_rows):
    """The SwiGLU FFN over [n_rows * E] dispatch buffers (C 200, padded to
    256) under autograd: output, dh, dW_gate, dW_up, dW_down of the
    kernel route against the plain route's; separate gate and up weights
    join into one [E, D, 2F] panel whose transpose the dX launch reads.
    fp32 at 1e-4; bf16 per element to `grad_rounding_bound`."""
    dev = cuda_device
    gen = torch.Generator(device="cpu").manual_seed(12)
    e, c, d, f = 4, 200, 128, 128
    h = torch.randn(n_rows * e, c, d, generator=gen).to(dev, dtype)
    ws = [(torch.randn(*shape, generator=gen) * shape[1] ** -0.5).to(dev, dtype)
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    dy = (torch.randn(n_rows * e, c, d, generator=gen) * c ** -0.5).to(dev, dtype)
    ge = None if n_rows == 1 else torch.arange(e, dtype=torch.int32, device=dev).repeat(n_rows)
    got = _with_grads(lambda *a: grouped_expert_ffn(*a, ge, backend="cuda"), (h, *ws), dy)
    want = _with_grads(lambda *a: grouped_expert_ffn(*a, ge, backend="ref"), (h, *ws), dy)
    for name, g, ref in zip(("out", "dh", "dw_gate", "dw_up", "dw_down"), got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(g, ref, atol=1e-4, rtol=1e-4, msg=name)
        else:
            err = (g.float() - ref.float()).abs()
            assert (err <= grad_rounding_bound(ref)).all(), (name, float(err.max()))


def test_moe_gemm_gradient_joins_a_panel_pair(cuda_device):
    """A tier buffer's gate|up pair under autograd: the kernel route joins
    the two panels, and both halves get their gradient."""
    dev = cuda_device
    rng = np.random.default_rng(13)
    te = _t([0, 1], dev, torch.int32)
    x = _t(rng.normal(size=(256, 64)), dev)
    buf = _t(rng.normal(size=(2, 3, 64, 48)), dev).requires_grad_()
    dy = _t(rng.normal(size=(256, 96)), dev)
    grads = []
    for backend in ("cuda", "ref"):
        buf.grad = None
        moe_gemm(x, (buf[:, 0], buf[:, 1]), te, backend=backend).backward(dy)
        grads.append(buf.grad.clone())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-4)
    assert grads[0][:, 2].abs().max() == 0 and grads[0][:, :2].abs().max() > 0


def test_expert_gemv_refuses_autograd(cuda_device):
    """The GEMV has no gradient (nor has the reference's Pallas kernel):
    on the card, tensors autograd would record raise; under no_grad it
    runs."""
    dev = cuda_device
    rng = np.random.default_rng(14)
    x = _t(rng.normal(size=(2, 3, 64)), dev)
    w1, w3 = (_t(rng.normal(size=(2, 64, 64)), dev) for _ in range(2))
    w2 = _t(rng.normal(size=(2, 64, 64)), dev).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        cold_expert_ffn(x, w1, w3, w2, backend="cuda")
    with torch.no_grad():
        assert torch.isfinite(cold_expert_ffn(x, w1, w3, w2, backend="cuda")).all()


@pytest.mark.parametrize("e,t,d,f", [
    (4, 3, 256, 128),
    (32, 4, 1024, 512),   # granite's flat decode step: all 32 experts as slots, cap = B
    (3, 5, 200, 136),     # D and F off the 64-wide box: TMA's zero fill on both edges
    (2, 40, 1024, 512),   # two token groups
])
def test_expert_gemv_bf16_takes_a_row_major_down_matrix(cuda_device, e, t, d, f):
    """The flat MoE's decode step hands the GEMV its [E, F, D] row-major
    w_down parameter, which the down pass reads in place (transposed out
    of shared memory); the result is held to `gemv_rounding_bound` like a
    tier buffer's, and equals, bitwise, the same weights read through a
    tier buffer's layout (unit stride along F): the same products summed
    in the same order."""
    dev = cuda_device
    gen = torch.Generator(device="cpu").manual_seed(15 + t)
    x = torch.randn(e, t, d, generator=gen).to(dev, torch.bfloat16)
    w1, w3 = ((torch.randn(e, d, f, generator=gen) * d ** -0.5).to(dev, torch.bfloat16)
              for _ in range(2))
    w2 = (torch.randn(e, f, d, generator=gen) * f ** -0.5).to(dev, torch.bfloat16)
    got = cold_expert_ffn(x, w1, w3, w2, backend="cuda")
    want = expert_ffn_gemv_ref(x, w1, w3, w2)
    assert ((got.float() - want.float()).abs() <= gemv_rounding_bound(x, w1, w3, w2)).all()
    tier_view = w2.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(expert_ffn_gemv(x, w1, w3, tier_view, backend="cuda"), got)


@pytest.mark.parametrize("kernel", ["moe_gemm", "expert_ffn_gemv", "flash_attention"])
def test_moe_gemm_bf16_launches_from_a_fresh_thread(cuda_device, kernel):
    """The backward pass runs on autograd's own thread, which may have made
    no CUDA runtime call (the caching allocator serves it): each bf16
    kernel that encodes TMA tensor maps binds its operands' device first,
    so the encode finds a context there."""
    import threading

    dev = cuda_device
    gen = torch.Generator(device="cpu").manual_seed(16)

    def bf16(*shape):
        return (torch.randn(*shape, generator=gen) * shape[-1] ** -0.5).to(dev, torch.bfloat16)

    if kernel == "moe_gemm":
        args = (bf16(256, 128), bf16(2, 256, 128).transpose(1, 2),
                torch.tensor([0, 1], dtype=torch.int32, device=dev))
        fn = moe_gemm
    elif kernel == "expert_ffn_gemv":
        args = (bf16(4, 3, 256), bf16(4, 256, 128), bf16(4, 256, 128), bf16(4, 128, 256))
        fn = expert_ffn_gemv
    else:
        args = (bf16(2, 128, 64), bf16(2, 128, 64), bf16(2, 128, 64))
        fn = flash_attention
    want = fn(*args, backend="cuda")  # warms the allocator's cache
    torch.cuda.synchronize()
    out = {}
    th = threading.Thread(target=lambda: out.setdefault("y", fn(*args, backend="cuda")))
    th.start()
    th.join()
    assert "y" in out and torch.equal(out["y"], want)
