"""Paged GQA attention for serving (port of repro/models/attention.py:
`init_gqa` :38, `_paged_write` :364, `paged_scatter` :374,
`gqa_decode_paged` :390, `gqa_prefill_paged` :495).

K/V live in shared block pools [N+1, bs, Kv, hd] whose last block is
the write trash: pad rows and dead rows write there, never into a
(possibly shared) live block. The pools are updated IN PLACE (the JAX
functions return new pools; here the same tensors come back, written),
which saves a copy of every pool per layer per step. The attention
itself is the paged-attention kernel family
(kernels/paged_attention), decode being its chunk-of-1 case.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_decode_gqa, paged_prefill_gqa
from repro_torch.models.layers import Params, apply_rope, dense_init, torch_dtype


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


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, theta: float):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


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
