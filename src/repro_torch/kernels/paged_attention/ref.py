"""Plain PyTorch versions of the paged-attention kernels (port of
repro/kernels/paged_attention/ref.py).

Dense-gather semantics: linearize each row's blocks by table, mask key
positions causally against each query's absolute position, exact
softmax. Scores and the PV product sum in fp32, with P rounded to the
value dtype first, as the GQA kernel does; in fp32 this is the JAX
oracle's arithmetic. The MLA version keeps everything in fp32: scores
from fp32 latent queries against the pool-dtype latents, and P times
the latents read as fp32, never rounded to the pool dtype. Pad queries
(beyond a row's real `lengths`) get a finite output the caller discards; only the causal position mask shapes real
queries' attention, so decode is `past_len = pos, lengths = 1`.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def linearize_blocks(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool [N+1, bs, ...] gathered by tables [B, nb] -> [B, nb*bs, ...].
    Row b's logical position t lives at pool[tables[b, t // bs], t % bs]."""
    g = pool[tables.long()]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def paged_prefill_gqa_ref(q, pool_k, pool_v, tables, past_len, lengths=None):
    """q: [B, C, Kv, G, hd]; pools [N+1, bs, Kv, hd]; tables [B, nb];
    past_len [B] -> [B, C, Kv, G, hd] in q's dtype. `lengths` is taken
    for signature parity with the kernel; real queries depend only on
    the position mask."""
    del lengths
    keys = linearize_blocks(pool_k, tables).float()  # [B, S, Kv, hd]
    vals = linearize_blocks(pool_v, tables)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bckgd,bskd->bckgs", q.float(), keys) * scale
    c = q.shape[1]
    qpos = past_len.to(torch.int64)[:, None] + torch.arange(c, device=q.device)[None, :]
    kpos = torch.arange(keys.shape[1], device=q.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]  # [B, C, S]
    s = torch.where(valid[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(vals.dtype).float()
    return torch.einsum("bckgs,bskd->bckgd", p, vals.float()).to(q.dtype)


def gqa_rounding_bound(q, pool_k, pool_v, tables, past_len):
    """Elementwise bound on |kernel - paged_prefill_gqa_ref| when the
    pools are in a 16-bit dtype, as flash attention's `rounding_bound`:
    each side rounds every p to v's dtype (the kernel p = exp(s - the
    running max of its key tiles), this version the normalized
    softmax), at most eps/2 off relative, so the PV sums differ by at
    most eps * sum(p |v|); and each rounds its output, at most one ulp
    <= eps * |o| apart."""
    eps = torch.finfo(pool_v.dtype).eps
    o = paged_prefill_gqa_ref(q, pool_k, pool_v, tables, past_len).float().abs()
    return eps * (o + paged_prefill_gqa_ref(q, pool_k, pool_v.abs(), tables, past_len).float())


def paged_decode_gqa_ref(q, pool_k, pool_v, tables, pos):
    """q: [B, Kv, G, hd]; pos [B] -> [B, Kv, G, hd] (chunk-of-1)."""
    return paged_prefill_gqa_ref(q[:, None], pool_k, pool_v, tables, pos)[:, 0]


def paged_prefill_mla_ref(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len,
                          lengths=None, *, scale: float):
    """q_lat: [B, C, H, r] fp32; q_rope: [B, C, H, rd] fp32; latent pools
    [N+1, bs, r | rd]; tables [B, nb]; past_len [B] -> o_lat [B, C, H, r]
    fp32. `lengths` as in `paged_prefill_gqa_ref`."""
    del lengths
    ckv = linearize_blocks(pool_ckv, tables).float()  # [B, S, r]
    krope = linearize_blocks(pool_krope, tables).float()  # [B, S, rd]
    s = (torch.einsum("bchr,btr->bcht", q_lat.float(), ckv)
         + torch.einsum("bchr,btr->bcht", q_rope.float(), krope)) * scale
    c = q_lat.shape[1]
    qpos = past_len.to(torch.int64)[:, None] + torch.arange(c, device=q_lat.device)[None, :]
    kpos = torch.arange(ckv.shape[1], device=q_lat.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]  # [B, C, S]
    s = torch.where(valid[:, :, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bcht,btr->bchr", p, ckv)


def paged_decode_mla_ref(q_lat, q_rope, pool_ckv, pool_krope, tables, pos, *,
                         scale: float):
    """Chunk-of-1: q_lat [B, H, r], q_rope [B, H, rd] -> o_lat [B, H, r]."""
    return paged_prefill_mla_ref(q_lat[:, None], q_rope[:, None], pool_ckv, pool_krope,
                                 tables, pos, scale=scale)[:, 0]


def split_bf16(x: torch.Tensor, terms: int) -> list:
    """x as `terms` bf16 tensors, hi = bf16(x), then bf16 of each
    remainder, as the bf16 MLA kernel splits q (3 terms) and P (2): the
    terms sum to x to 8 * terms significant bits (3 terms: every fp32)."""
    out, rest = [], x.float()
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return out


def paged_prefill_mla_split(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len,
                            lengths=None, *, scale: float, q_terms: int = 3,
                            p_terms: int = 2, key_tile: int = 64):
    """The bf16-pool kernel's arithmetic, for the tests: scores from q
    split into `q_terms` bf16 terms (each product with a bf16 latent exact
    in fp32, summed in fp32), an online softmax over key tiles of
    `key_tile`, and P split into `p_terms` bf16 terms before the product
    with the latents. Same signature and result layout as
    `paged_prefill_mla_ref`."""
    del lengths
    ckv = linearize_blocks(pool_ckv, tables).float()  # [B, S, r]
    keys = torch.cat([ckv, linearize_blocks(pool_krope, tables).float()], -1)
    q_parts = [t.float() for t in split_bf16(torch.cat([q_lat, q_rope], -1), q_terms)]
    b, c, h, r = q_lat.shape
    qpos = past_len.to(torch.int64)[:, None] + torch.arange(c, device=q_lat.device)[None, :]
    m = torch.full((b, c, h), NEG_INF, device=q_lat.device)
    den = torch.zeros((b, c, h), device=q_lat.device)
    o = torch.zeros((b, c, h, r), device=q_lat.device)
    for t0 in range(0, keys.shape[1], key_tile):
        kt = keys[:, t0:t0 + key_tile]
        s = sum(torch.einsum("bchd,btd->bcht", qp, kt) for qp in q_parts) * scale
        kpos = torch.arange(t0, t0 + kt.shape[1], device=q_lat.device)
        valid = kpos[None, None, :] <= qpos[:, :, None]
        s = torch.where(valid[:, :, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * alpha + p.sum(-1)
        o = o * alpha[..., None] + sum(
            torch.einsum("bcht,btr->bchr", pp.float(), ckv[:, t0:t0 + key_tile])
            for pp in split_bf16(p, p_terms))
        m = m_new
    return o / den.clamp_min(1e-30)[..., None]
