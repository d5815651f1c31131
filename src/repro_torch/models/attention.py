"""GQA and MLA attention for serving (port of repro/models/attention.py:
`init_gqa` :38, `init_mla` :56, `_grouped_attention` :75, `gqa_forward`
:180, `gqa_decode` :211, `mla_forward` :242, `mla_decode` :292,
`_paged_write` :364, `paged_scatter` :374, `gqa_decode_paged` :390,
`mla_decode_paged` :438, `gqa_prefill_paged` :495, `mla_prefill_paged`
:552).

Two cache layouts. The contiguous one ("slots") holds a ring buffer of
static length S per row: `gqa_forward` / `mla_forward` run whole
sequences (prefill) and return the tokens' cache entries, `gqa_decode` /
`mla_decode` write one token per row at `pos % S` (in place) and attend
over the row's valid slots. These are plain PyTorch, as the reference's
are plain jnp (they reach no Pallas kernel); `_grouped_attention` is the
reference's query-chunked exact softmax. The sequence-parallel branch of
the reference waits for the distributed slice.

K/V (GQA) and the MLA latents live in shared block pools [N+1, bs, ...]
whose last block is the write trash: pad rows and dead rows write there,
never into a (possibly shared) live block. The pools are updated IN PLACE
(the JAX functions return new pools; here the same tensors come back,
written), which saves a copy of every pool per layer per step. The
attention itself is the paged-attention kernel family
(kernels/paged_attention), decode being its chunk-of-1 case.

MLA runs absorbed: W_k^nope is folded into the query (`q_lat`), the
kernel attends over the latent pools and returns latent outputs, and the
W_v expansion and output projection stay out here. Those latent
contractions run in fp32 (the operands are cast first; TF32 stays off),
as the reference's `preferred_element_type=f32`: a bf16 accumulation
over the kv_lora_rank-wide latent drifts decode measurably.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import (
    paged_decode_gqa,
    paged_decode_mla,
    paged_prefill_gqa,
    paged_prefill_mla,
)
from repro_torch.models.layers import Params, apply_rope, dense_init, torch_dtype

NEG_INF = -1e30


def init_gqa(gen: torch.Generator, cfg, lead=()) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (d, h, hd), dt, lead=lead),
        "wk": dense_init(gen, (d, kv, hd), dt, lead=lead),
        "wv": dense_init(gen, (d, kv, hd), dt, lead=lead),
        "wo": dense_init(gen, (h, hd, d), dt, lead=lead),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((*lead, h, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((*lead, kv, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((*lead, kv, hd), dtype=dt, device=dev)
    return p


def init_mla(gen: torch.Generator, cfg, lead=()) -> Params:
    m, d = cfg.mla, cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    h = cfg.n_heads
    return {
        # q: direct projection to nope + rope dims per head
        "wq": dense_init(gen, (d, h, m.qk_nope_head_dim + m.qk_rope_head_dim), dt,
                         lead=lead),
        # kv_a: down-projection to the latent + the shared rope key
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dt, lead=lead),
        # kv_b: latent -> per-head (k_nope, v)
        "wkv_b": dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim),
                            dt, lead=lead),
        "wo": dense_init(gen, (h, m.v_head_dim, d), dt, lead=lead),
    }


def gqa_cache_shapes(cfg, n_tokens: int) -> dict:
    """Token-addressed cache leaves of a GQA layer, in the order the
    paged functions take them (reference `init_layer_cache` :147-158)."""
    kv = (n_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": kv, "v": kv}


def mla_cache_shapes(cfg, n_tokens: int) -> dict:
    """Token-addressed cache leaves of an MLA layer: the latent and the
    shared rope key."""
    m = cfg.mla
    return {"ckv": (n_tokens, m.kv_lora_rank), "krope": (n_tokens, m.qk_rope_head_dim)}


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, theta: float):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


# ------------------------------------------------- grouped core attention
def _grouped_attention(q, k, v, *, causal: bool = False, valid=None,
                       q_chunk: int = 1024):
    """q [B, Sq, H, hd]; k / v [B, Sk, Kv, hd_{k,v}] -> [B, Sq, H, hd_v].

    Exact softmax per query row, over query chunks of `q_chunk` rows so the
    score tensor never exceeds one chunk. Causal: query i sits at absolute
    position i + (Sk - Sq). `valid`: optional [Sk] or [B, Sk] bool of usable
    keys (pad keys of a masked prefill, a decode ring's filled slots).
    Scores are taken in the inputs' dtype and then scaled in fp32; the
    softmax is fp32 and cast to v's dtype for the value product, as in
    the reference."""
    b, sq, h, hdk = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hdk)
    scale = hdk ** -0.5
    kpos = torch.arange(sk, device=q.device)
    vmask = None
    if valid is not None:
        vmask = valid[None, None, :] if valid.ndim == 1 else valid[:, None, :]
    outs = []
    for start in range(0, sq, q_chunk):
        qc = qg[:, start:start + q_chunk]
        s = torch.einsum("bckgd,bskd->bckgs", qc, k).float() * scale
        mask = None
        if causal:
            qpos = start + torch.arange(qc.shape[1], device=q.device) + (sk - sq)
            mask = (kpos[None, :] <= qpos[:, None])[None]  # [1, C, Sk]
        if vmask is not None:
            mask = vmask if mask is None else (mask & vmask)
        if mask is not None:
            s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bckgs,bskd->bckgd", p.to(v.dtype), v))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, sq, h, -1)


# ---------------------------------------------- contiguous (slots) layout
def gqa_forward(p: Params, cfg, x, positions, token_mask=None):
    """Full-sequence causal GQA (prefill). x [B, S, D]; positions [B or 1,
    S]; token_mask [B, S] real tokens (pad keys masked; outputs at pad
    queries are unspecified). Returns (out [B, S, D], (k, v)) with the
    tokens' k / v [B, S, Kv, hd] for the cache."""
    q, k, v = _qkv(p, x, positions, cfg.rope_theta)
    out = _grouped_attention(q, k, v, causal=True, valid=token_mask)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def _ring_write(cache, pos, val):
    """val [B, ...] lands at cache[b, pos[b] % S], in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, (pos % cache.shape[1]).long()] = val
    return cache


def gqa_decode(p: Params, cfg, x, cache_k, cache_v, pos):
    """One-token GQA decode against ring buffers. x [B, 1, D]; cache_k /
    cache_v [B, S, Kv, hd]; pos [B] int32 absolute positions. The new
    token's K/V overwrites slot pos % S (in place), then attention runs
    over the slots filled so far (arange(S) <= pos). Returns (out [B, 1,
    D], cache_k, cache_v)."""
    q, k, v = _qkv(p, x, pos[:, None], cfg.rope_theta)
    _ring_write(cache_k, pos, k[:, 0])
    _ring_write(cache_v, pos, v[:, 0])
    valid = torch.arange(cache_k.shape[1], device=x.device)[None, :] <= pos[:, None]
    out = _grouped_attention(q, cache_k, cache_v, valid=valid)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def mla_forward(p: Params, cfg, x, positions, token_mask=None):
    """Full-sequence causal MLA (prefill), expanded: the latent becomes
    per-head K/V (`kvb` [B, S, H, nope + v]) and attention is GQA with one
    query per KV head. Returns (out [B, S, D], (ckv [B, S, r], krope
    [B, S, rd])), the tokens' cache entries."""
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv, krope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    krope = apply_rope(krope[:, :, None, :], positions, cfg.rope_theta)  # [B, S, 1, rd]
    kvb = torch.einsum("bsr,rhk->bshk", ckv, p["wkv_b"])
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, krope.expand(*k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = _grouped_attention(qf, k, v, causal=True, valid=token_mask)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (ckv, krope[:, :, 0, :])


def mla_decode(p: Params, cfg, x, cache_ckv, cache_krope, pos):
    """Absorbed one-token MLA decode against latent ring buffers. x [B, 1,
    D]; cache_ckv [B, S, r]; cache_krope [B, S, rd]; pos [B] int32. The
    new token's latents overwrite slot pos % S (in place); scores and
    values are taken against the latents directly, every latent
    contraction in fp32 as the reference's `preferred_element_type=f32`.
    Returns (out [B, 1, D], cache_ckv, cache_krope)."""
    q_lat, q_rope, ckv_new, krope_new, wv_b = _mla_project(p, cfg, x, pos[:, None])
    _ring_write(cache_ckv, pos, ckv_new[:, 0])
    _ring_write(cache_krope, pos, krope_new[:, 0])
    ckv, krope = cache_ckv.float(), cache_krope.float()
    s = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
         + torch.einsum("bshk,btk->bhst", q_rope, krope)) * _mla_scale(cfg)
    valid = torch.arange(ckv.shape[1], device=x.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    o_lat = torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1), ckv)
    return _mla_out(p, o_lat, wv_b, x.dtype), cache_ckv, cache_krope


# ------------------------------------------------------- paged layout
def _paged_write(pool, tables, pos, val):
    """Scatter one new token per row into its block, in place: val [B, ...]
    lands at pool[tables[b, pos[b] // bs], pos[b] % bs]. Dead rows carry
    all-trash tables, so their writes fall into the sentinel block."""
    bs = pool.shape[1]
    rows = torch.arange(tables.shape[0], device=tables.device)
    bid = tables[rows, pos // bs].long()
    pool[bid, (pos % bs).long()] = val
    return pool


def paged_scatter(pool, tables, gpos, mask, val):
    """Scatter a CHUNK of new-token entries into a block pool, in place.
    pool [N+1, bs, ...]; tables [W, nb]; gpos [W, C] global positions;
    mask [W, C] real tokens; val [W, C, ...]. Masked (pad) positions
    write to the trash block (last pool row)."""
    bs = pool.shape[1]
    trash = pool.shape[0] - 1
    lb = torch.clamp(gpos // bs, max=tables.shape[1] - 1).long()
    bid = torch.gather(tables, 1, lb).long()  # [W, C]
    bid = torch.where(mask, bid, torch.full_like(bid, trash))
    pool[bid, (gpos % bs).long()] = val
    return pool


def gqa_decode_paged(p: Params, cfg, x, pool_k, pool_v, tables, pos):
    """One-token GQA decode against paged pools. x [B, 1, D]; tables
    [B, nb] int32; pos [B] int32 absolute positions. The new token's K/V
    is written to its row's tail block first, then attention runs over
    the row's blocks. Returns (out [B, 1, D], pool_k, pool_v)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, pos[:, None], cfg.rope_theta)
    _paged_write(pool_k, tables, pos, k[:, 0])
    _paged_write(pool_v, tables, pos, v[:, 0])
    kvh = pool_k.shape[2]
    qk = q[:, 0].reshape(b, kvh, q.shape[2] // kvh, q.shape[3])
    out = paged_decode_gqa(qk, pool_k, pool_v, tables, pos,
                           backend=cfg.paged_attn_backend)
    out = out.reshape(b, 1, q.shape[2], q.shape[3])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), pool_k, pool_v


def gqa_prefill_paged(p: Params, cfg, x, pool_k, pool_v, tables, past_len,
                      positions, token_mask):
    """Chunked suffix prefill against paged pools: the decode contract
    widened to a [rows, chunk] query tile. x [W, C, D] right-padded
    chunks; tables [W, nb] sliced to the active width; past_len [W];
    positions [W, C] = past_len + arange; token_mask [W, C] real tokens.
    The chunk's K/V is scattered first (pads to the trash block), then
    attention walks each row's blocks with per-query causal masking.
    Returns (out [W, C, D], pool_k, pool_v)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg.rope_theta)
    paged_scatter(pool_k, tables, positions, token_mask, k)
    paged_scatter(pool_v, tables, positions, token_mask, v)
    lengths = token_mask.sum(-1).to(torch.int32)
    kvh = pool_k.shape[2]
    qk = q.reshape(b, c, kvh, q.shape[2] // kvh, q.shape[3]).contiguous()
    out = paged_prefill_gqa(qk, pool_k, pool_v, tables, past_len, lengths,
                            backend=cfg.paged_attn_backend)
    out = out.reshape(b, c, q.shape[2], q.shape[3]).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), pool_k, pool_v


def _mla_project(p: Params, cfg, x, positions):
    """Absorbed MLA projections of x [B, S, D] at `positions` [B, S]:
    (q_lat [B, S, H, r] fp32, q_rope [B, S, H, rd] fp32, ckv_new [B, S, r],
    krope_new [B, S, rd], wv_b [r, H, v])."""
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv_new, krope_new = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    krope_new = apply_rope(krope_new[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    wk_b, wv_b = p["wkv_b"].split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(), wk_b.float())
    return q_lat.contiguous(), q_rope.float().contiguous(), ckv_new, krope_new, wv_b


def _mla_out(p: Params, o_lat, wv_b, dtype):
    """Latent outputs o_lat [B, S, H, r] fp32 -> [B, S, D]: the W_v
    expansion in fp32, cast to the activation dtype, then wo."""
    o = torch.einsum("bshr,rhk->bshk", o_lat, wv_b.float()).to(dtype)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _mla_scale(cfg) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_decode_paged(p: Params, cfg, x, pool_ckv, pool_krope, tables, pos):
    """Absorbed one-token MLA decode against paged latent pools. x [B, 1,
    D]; pool_ckv [N+1, bs, r]; pool_krope [N+1, bs, rd]; tables [B, nb]
    int32; pos [B] int32. The new token's latents are written first, then
    the kernel attends in latent space. Returns (out [B, 1, D], pool_ckv,
    pool_krope)."""
    q_lat, q_rope, ckv_new, krope_new, wv_b = _mla_project(p, cfg, x, pos[:, None])
    _paged_write(pool_ckv, tables, pos, ckv_new[:, 0])
    _paged_write(pool_krope, tables, pos, krope_new[:, 0])
    o_lat = paged_decode_mla(q_lat[:, 0], q_rope[:, 0], pool_ckv, pool_krope, tables, pos,
                             scale=_mla_scale(cfg), backend=cfg.paged_attn_backend)
    return _mla_out(p, o_lat[:, None], wv_b, x.dtype), pool_ckv, pool_krope


def mla_prefill_paged(p: Params, cfg, x, pool_ckv, pool_krope, tables, past_len,
                      positions, token_mask):
    """Absorbed chunked MLA suffix prefill against paged latent pools:
    `mla_decode_paged` widened to a [rows, chunk] query tile, arguments as
    in `gqa_prefill_paged`. Returns (out [W, C, D], pool_ckv, pool_krope)."""
    q_lat, q_rope, ckv_new, krope_new, wv_b = _mla_project(p, cfg, x, positions)
    paged_scatter(pool_ckv, tables, positions, token_mask, ckv_new)
    paged_scatter(pool_krope, tables, positions, token_mask, krope_new)
    lengths = token_mask.sum(-1).to(torch.int32)
    o_lat = paged_prefill_mla(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len,
                              lengths, scale=_mla_scale(cfg),
                              backend=cfg.paged_attn_backend)
    return _mla_out(p, o_lat, wv_b, x.dtype), pool_ckv, pool_krope
