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
products in another order, then one bf16 rounding of the output.

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
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.moe_gemm.ref import join_panels, moe_gemm_ref
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
    w2 = torch.ones(2, 32, 64, dtype=torch.bfloat16, device=dev)  # F not contiguous
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


@pytest.mark.parametrize("hd", [64, 128])
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
