"""The port's plain PyTorch versions of the three serving kernels against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
the JAX tests run them, on the same seeded numpy inputs. The CUDA
kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: fp32 comparisons are tight (atol/rtol 1e-5; the same
products summed in another order). bf16 comparisons allow 2e-2: both
sides round the output (and P or h) to bf16, 8 mantissa bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.expert_gemv import cold_expert_ffn as jax_cold_expert_ffn
from repro.kernels.moe_gemm import grouped_expert_ffn as jax_grouped_expert_ffn
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro.kernels.paged_attention import paged_decode_gqa as jax_paged_decode_gqa
from repro.kernels.paged_attention import paged_prefill_gqa as jax_paged_prefill_gqa
from repro_torch.kernels import backend
from repro_torch.kernels.backend import use_kernel
from repro_torch.kernels.expert_gemv import cold_expert_ffn, gemv_rounding_bound
from repro_torch.kernels.expert_gemv.kernel import mma_addressable, mma_plan, w2_layout
from repro_torch.kernels.moe_gemm import grouped_expert_ffn, moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.paged_attention import (
    gqa_rounding_bound,
    linearize_blocks,
    paged_decode_gqa,
    paged_prefill_gqa,
)
from repro_torch.kernels.paged_attention.kernel import GQA_BLOCKS_PER_SM, key_splits
from repro_torch.serving.tiered_moe import _dispatch_tier

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dt: str):
    """The same numpy array as a JAX array and a torch tensor of dtype dt."""
    return jnp.asarray(a, JDT[dt]), torch.tensor(a, dtype=torch.float32).to(TDT[dt])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------- attention
def _attention_case(seed, b, c, kv, g, hd, bs, nb, dead=(), all_pad=()):
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + 3
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb).astype(np.int32)
    past = rng.integers(0, (nb * bs) - c + 1, size=b).astype(np.int32)
    lengths = rng.integers(1, c + 1, size=b).astype(np.int32)
    for r in dead:  # dead decode row: all-trash table
        tables[r] = n_blocks
        lengths[r] = 0
    for r in all_pad:  # all-pad prefill row
        lengths[r] = 0
    q = rng.normal(size=(b, c, kv, g, hd))
    pk = rng.normal(size=(n_blocks + 1, bs, kv, hd))
    pv = rng.normal(size=(n_blocks + 1, bs, kv, hd))
    return q, pk, pv, tables, past, lengths


# the (Kv, G) pairs the dense family brings at head width 128: llama3.2-3b /
# phi4-mini (8, 3), qwen2.5-32b (8, 5), chameleon-34b (8, 8), granite-20b
# (1, 48: MQA), Kv cut to 2 where it is 8 (the kernel's grid runs over KV
# heads independently); a decode step and a 4-token chunk each
DENSE_GQA = [pytest.param(100 + 10 * g + c, 4, c, g, 4, 5, kv, 128, id=f"dense-kv{kv}-g{g}-c{c}")
             for kv, g in [(2, 3), (2, 5), (2, 8), (1, 48)] for c in (1, 4)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,b,c,g,bs,nb,kv,hd", [
    pytest.param(0, 3, 4, 2, 4, 4, 2, 16, id="0-3-4-2-4-4"),
    pytest.param(1, 2, 8, 1, 2, 8, 2, 16, id="1-2-8-1-2-8"),
    pytest.param(2, 4, 3, 2, 8, 2, 2, 16, id="2-4-3-2-8-2"),
    *DENSE_GQA,
])
def test_paged_prefill_plain_matches_pallas(dt, seed, b, c, g, bs, nb, kv, hd):
    q, pk, pv, tables, past, lengths = _attention_case(
        seed, b, c, kv=kv, g=g, hd=hd, bs=bs, nb=nb, all_pad=(b - 1,))
    jq, tq = _both(q, dt)
    jk, tk = _both(pk, dt)
    jv, tv = _both(pv, dt)
    want = jax_paged_prefill_gqa(jq, jk, jv, jnp.asarray(tables), jnp.asarray(past),
                                 jnp.asarray(lengths), interpret=True)
    got = paged_prefill_gqa(tq, tk, tv, torch.tensor(tables), torch.tensor(past),
                            torch.tensor(lengths))
    assert got.dtype == TDT[dt] and got.shape == q.shape
    assert np.isfinite(_np(got)).all()
    real = np.arange(c)[None, :] < lengths[:, None]  # pad queries are discarded
    np.testing.assert_allclose(_np(got)[real], _np(want)[real],
                               atol=TOL[dt], rtol=TOL[dt])


def test_paged_decode_chunk_of_one_and_dead_rows():
    """Decode is the chunk-of-1 prefill; a dead row (all-trash table)
    still gives a finite output."""
    q, pk, pv, tables, past, _ = _attention_case(5, 4, 1, kv=2, g=2, hd=16, bs=4,
                                                 nb=4, dead=(2,))
    tq, tk, tv = (torch.tensor(a, dtype=torch.float32) for a in (q, pk, pv))
    tt, tp = torch.tensor(tables), torch.tensor(past)
    dec = paged_decode_gqa(tq[:, 0], tk, tv, tt, tp)
    chunk = paged_prefill_gqa(tq, tk, tv, tt, tp, torch.ones_like(tp))[:, 0]
    torch.testing.assert_close(dec, chunk, rtol=0, atol=0)
    assert torch.isfinite(dec).all()
    want = jax_paged_decode_gqa(jnp.asarray(q[:, 0], jnp.float32), jnp.asarray(pk, jnp.float32),
                                jnp.asarray(pv, jnp.float32), jnp.asarray(tables),
                                jnp.asarray(past), interpret=True)
    live = np.array([True, True, False, True])
    np.testing.assert_allclose(_np(dec)[live], _np(want)[live], atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ moe_gemm
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_gemm_plain_matches_pallas_uneven_groups(dt):
    """Uneven expert groups: tile t of 128 rows uses expert te[t]."""
    rng = np.random.default_rng(10)
    te = np.array([0, 0, 2, 3, 3], np.int32)  # expert 1 has no rows
    x = rng.normal(size=(128 * len(te), 64))
    w = rng.normal(size=(4, 64, 256)) * 64 ** -0.5
    jx, tx = _both(x, dt)
    jw, tw = _both(w, dt)
    want = jax_moe_gemm(jx, jw, jnp.asarray(te), interpret=True)
    got = moe_gemm(tx, tw, torch.tensor(te))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=TOL[dt])
    # two [E, K, N/2] panels read side by side equal the joined weight
    halves = (tw[..., :128], tw[..., 128:])
    torch.testing.assert_close(moe_gemm_ref(tx, halves, torch.tensor(te)), got)


@pytest.mark.parametrize("c", [5, 130])
def test_grouped_expert_ffn_matches_pallas(c):
    """Groups mapped to experts unevenly, C not a multiple of the tile,
    weights as views of a [n, 3, D, F] tier buffer (down transposed)."""
    rng = np.random.default_rng(11)
    d, f, n = 32, 96, 3
    buf = rng.normal(size=(n, 3, d, f)) * d ** -0.5
    h = rng.normal(size=(4, c, d))
    ge = np.array([2, 0, 2, 1], np.int32)
    want = jax_grouped_expert_ffn(
        jnp.asarray(h, jnp.float32), jnp.asarray(buf[:, 0], jnp.float32),
        jnp.asarray(buf[:, 1], jnp.float32),
        jnp.asarray(buf[:, 2].transpose(0, 2, 1), jnp.float32),
        jnp.asarray(ge), backend="pallas")
    tb = torch.tensor(buf, dtype=torch.float32)
    got = grouped_expert_ffn(torch.tensor(h, dtype=torch.float32), tb[:, 0], tb[:, 1],
                             tb[:, 2].transpose(1, 2), torch.tensor(ge))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------- expert GEMV
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [64, 96])  # 96: F zero-padded to the panel
def test_cold_expert_ffn_matches_pallas(dt, f):
    rng = np.random.default_rng(12)
    e, t, d = 3, 4, 32
    x = rng.normal(size=(e, t, d))
    w1 = rng.normal(size=(e, d, f)) * d ** -0.5
    w3 = rng.normal(size=(e, d, f)) * d ** -0.5
    w2 = rng.normal(size=(e, f, d)) * f ** -0.5
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = (_both(a, dt) for a in (x, w1, w3, w2))
    want = jax_cold_expert_ffn(jx, j1, j3, j2, bf=64, backend="pallas")
    got = cold_expert_ffn(tx, t1, t3, t2)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=TOL[dt])


# The bf16 GEMV skips every tier slot whose token rows are all zero.
# That is exact on the serving path because (1) dispatch leaves every
# unassigned row of a tier buffer exactly zero and (2) the expert FFN maps
# a zero row to an exactly zero row, in the JAX kernel and in the port.
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dispatch_leaves_unassigned_rows_zero(dt):
    rng = np.random.default_rng(13)
    t, k, n_slots, cap, d = 6, 3, 5, 4, 16
    flat = torch.tensor(rng.normal(size=(t, d)), dtype=torch.float32).to(TDT[dt])
    st = torch.arange(t).repeat_interleave(k)
    slot = torch.tensor(rng.integers(0, n_slots, t * k))
    in_tier = torch.tensor(rng.random(t * k) < 0.6)
    buf, dst, ok = _dispatch_tier(flat, st, slot, in_tier, n_slots, cap)
    rows = buf.reshape(n_slots * cap, d)
    assigned = torch.zeros(n_slots * cap, dtype=torch.bool)
    assigned[dst[ok]] = True
    assert bool((rows[~assigned] == 0).all())
    assert torch.equal(rows[dst[ok]], flat[st[ok]])
    assert not bool(assigned.all())  # the case has empty rows to check


def _ffn_case(seed, e, t, d, f):
    """Token buffers with one all-zero slot and zero rows in the others."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, t, d))
    x[1] = 0.0
    x[0, 1:] = 0.0
    x[2, 0] = 0.0
    w1 = rng.normal(size=(e, d, f)) * d ** -0.5
    w3 = rng.normal(size=(e, d, f)) * d ** -0.5
    w2 = rng.normal(size=(e, f, d)) * f ** -0.5
    return x, w1, w3, w2, (x == 0).all(-1)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_zero_token_rows_give_zero_rows_in_pallas_and_port(dt):
    x, w1, w3, w2, zero = _ffn_case(14, 4, 3, 32, 64)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = (_both(a, dt) for a in (x, w1, w3, w2))
    want = _np(jax_cold_expert_ffn(jx, j1, j3, j2, bf=64, backend="pallas"))
    got = _np(cold_expert_ffn(tx, t1, t3, t2))
    for out in (want, got):
        assert (out[zero] == 0).all()
        assert (np.abs(out[~zero]).sum(-1) > 0).all()


@pytest.mark.parametrize("d,f,want", [
    (5120, 1536, (4, 1)),  # deepseek: D = 80 stages over 4 CTAs, F = 24 stages
    (1024, 512, (1, 1)),   # granite: 16 and 8 stages, no split
    (8192, 2048, (8, 2)),
    (64, 32, (1, 1)),
])
def test_gemv_mma_plan_keeps_16_stages_a_cta(d, f, want):
    plan = mma_plan(d, f)
    assert plan == want
    for depth, cs in zip((d, f), plan):
        stages = -(-depth // 64)
        assert cs == 1 or stages >= 16 * cs  # each CTA keeps 16 stages
        assert cs == 8 or stages < 16 * 2 * cs  # and a larger cluster would not


def test_gemv_mma_addressable():
    """The bf16 passes read tier-buffer views in place (F contiguous),
    F off the 64-wide panel included, and a row-major [E, F, D] down
    matrix (D contiguous: the flat MoE's parameter); a down matrix with
    unit stride along neither, or D or F off the 16-byte granule, is
    refused."""
    buf = torch.randn(3, 3, 64, 40, dtype=torch.bfloat16)
    x = torch.randn(3, 2, 64, dtype=torch.bfloat16)
    views = (buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2))
    assert mma_addressable(x, *views)
    assert w2_layout(views[2]) == (False, 40)
    row_major = views[2].contiguous()
    assert mma_addressable(x, views[0], views[1], row_major)
    assert w2_layout(row_major) == (True, 64)
    strided = torch.randn(3, 40, 128, dtype=torch.bfloat16)[..., ::2]
    assert not mma_addressable(x, views[0], views[1], strided)
    assert not mma_addressable(x[..., :60].contiguous(), views[0][:, :60],
                               views[1][:, :60], views[2][..., :60])
    assert not mma_addressable(x, views[0][..., :36], views[1][..., :36],
                               views[2][:, :36])


def _gemv_bf16(x, w1, w3, w2, round_h=True, chunk=64):
    """The bf16 GEMV kernel's arithmetic on the CPU: g, u and y summed in
    fp32 a 64-deep chunk at a time (the kernel's stages), h =
    silu(g) * u rounded to bf16 before W2 (`round_h=False` leaves it in
    fp32: a fault), y rounded to bf16."""
    def chunked(a, b):
        return sum(torch.bmm(a[..., k:k + chunk], b[:, k:k + chunk])
                   for k in range(0, a.shape[-1], chunk))
    xf = x.float()
    g, u = chunked(xf, w1.float()), chunked(xf, w3.float())
    h = g / (1 + torch.exp(-g)) * u
    h = h.to(torch.bfloat16).float() if round_h else h
    return chunked(h, w2.float()).to(torch.bfloat16)


@pytest.mark.parametrize("e,t,d,f", [(3, 4, 256, 128), (2, 9, 512, 320), (4, 1, 128, 512)])
def test_gemv_rounding_bound_holds_for_the_kernel_arithmetic(e, t, d, f):
    """`gemv_rounding_bound`, which the card holds the bf16 GEMV to, covers
    the kernel's own summation order and is tight enough that leaving h
    unrounded breaks it, once h's rounding errors line up with W2's
    signs (token 0's, here)."""
    rng = np.random.default_rng(15 + t)
    x = torch.tensor(rng.normal(size=(e, t, d)), dtype=torch.bfloat16)
    w1, w3 = (torch.tensor(rng.normal(size=(e, d, f)) * d ** -0.5, dtype=torch.bfloat16)
              for _ in range(2))
    w2 = torch.tensor(rng.normal(size=(e, f, d)) * f ** -0.5, dtype=torch.bfloat16)
    want = cold_expert_ffn(x, w1, w3, w2).float()
    bound = gemv_rounding_bound(x, w1, w3, w2)
    assert ((_gemv_bf16(x, w1, w3, w2).float() - want).abs() <= bound).all()
    xf = x.float()
    hf = F.silu(torch.bmm(xf, w1.float())) * torch.bmm(xf, w3.float())
    lined_up = torch.sign(hf - hf.to(torch.bfloat16).float())[:, 0, :, None] * w2.abs()
    bound = gemv_rounding_bound(x, w1, w3, lined_up)
    want = cold_expert_ffn(x, w1, w3, lined_up).float()
    assert ((_gemv_bf16(x, w1, w3, lined_up).float() - want).abs() <= bound).all()
    unrounded = _gemv_bf16(x, w1, w3, lined_up, round_h=False).float()
    assert ((unrounded - want).abs() > bound)[:, 0].any()


def _paged_gqa_bf16(q, pool_k, pool_v, tables, past_len, lengths, tile=64, drop_last=False):
    """The bf16 paged GQA kernel's arithmetic on the CPU: each row's
    walked keys (the TPU skip rule) in tiles of `tile`, running max and
    sum in fp32, p = exp(s - running max) rounded to bf16 before PV,
    output acc / max(l, 1e-30) rounded to bf16. `drop_last` skips each
    row's last walked tile (a fault)."""
    b, c, kv, g, hd = q.shape
    bs, nb = pool_k.shape[1], tables.shape[1]
    keys = linearize_blocks(pool_k, tables).float().permute(0, 2, 3, 1)  # [B, Kv, hd, S]
    vals = linearize_blocks(pool_v, tables).float().transpose(1, 2)  # [B, Kv, S, hd]
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(b, kv, c * g, hd)
    last = past_len + lengths - 1
    walked = torch.minimum(torch.full_like(last, nb), last.clamp_min(0) // bs + 1) * bs
    qpos = (past_len[:, None] + torch.arange(c)[None, :]).repeat_interleave(g, 1)
    m = torch.full((b, kv, c * g, 1), -1e30)
    den = torch.zeros(b, kv, c * g, 1)
    acc = torch.zeros(b, kv, c * g, hd)
    for t0 in range(0, nb * bs, tile):
        kpos = torch.arange(t0, min(t0 + tile, nb * bs))
        s = qf @ keys[..., kpos] * hd ** -0.5
        visible = (kpos[None, None, :] <= qpos[:, :, None])[:, None]  # [B, 1, C*G, keys]
        s = torch.where(visible, s, torch.full_like(s, -1e30))
        skip = kpos[None, :] >= walked[:, None]
        if drop_last:
            skip |= (walked[:, None] - 1) // tile == t0 // tile
        s = torch.where(skip[:, None, None, :], torch.full_like(s, -float("inf")), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        den, m = den * alpha + p.sum(-1, keepdim=True), m_new
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vals[:, :, kpos]
    o = (acc / den.clamp_min(1e-30)).to(torch.bfloat16)
    return o.reshape(b, kv, c, g, hd).permute(0, 2, 1, 3, 4)


@pytest.mark.parametrize("c,g,nb", [(1, 2, 64), (8, 4, 40), (32, 2, 24)])
def test_gqa_rounding_bound_holds_for_the_kernel_arithmetic(c, g, nb):
    """`gqa_rounding_bound`, which the card holds the bf16 paged GQA
    kernel to, covers the kernel's rounding over 64-key tiles, and a
    skipped key tile (each row's last one walked) breaks it. It cannot
    tell a kernel that leaves P unrounded from one that rounds it: the
    plain version rounds the normalized softmax, so both differ from it
    by up to the same eps per key."""
    q, pk, pv, tables, past, lengths = _attention_case(16 + c, b=4, c=c, kv=2, g=g, hd=64,
                                                       bs=4, nb=nb)
    q, pk, pv = (torch.tensor(a, dtype=torch.bfloat16) for a in (q, pk, pv))
    tables, past, lengths = (torch.tensor(a) for a in (tables, past, lengths))
    args = (q, pk, pv, tables, past, lengths)
    want = paged_prefill_gqa(*args).float()
    bound = gqa_rounding_bound(q, pk, pv, tables, past)
    real = (torch.arange(c)[None, :] < lengths[:, None])[..., None, None, None].expand_as(want)
    err = (_paged_gqa_bf16(*args).float() - want).abs()
    assert (err <= bound)[real].all()
    dropped = (_paged_gqa_bf16(*args, drop_last=True).float() - want).abs()
    assert (dropped > bound)[real].any()


@pytest.mark.parametrize("pairs,key_tiles,want", [
    (32, 1, 1),     # one key tile: nothing to split
    (32, 2, 1),     # two tiles: the combine costs more than a split saves
    (32, 64, 16),   # decode over a long cache: 32 pairs x 16 splits <= 4 x 132 SMs
    (1024, 64, 1),  # enough blocks already
    (2, 8, 4),      # capped at two tiles a split
])
def test_gqa_splits(pairs, key_tiles, want):
    assert key_splits(pairs, key_tiles, 132, GQA_BLOCKS_PER_SM) == want


# ------------------------------------------------------ backend rule
def test_backend_rule_by_device(monkeypatch):
    cpu = torch.zeros(1)
    assert use_kernel("auto", cpu) is False
    assert use_kernel("ref", cpu) is False
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        use_kernel("cuda", cpu)
    with pytest.raises(ValueError, match="unknown"):
        use_kernel("pallas", cpu)
    # a card that is not Hopper raises instead of falling back
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "A100")
    with pytest.raises(RuntimeError, match="sm_80"):
        backend._check_card(torch.device("cuda"))
