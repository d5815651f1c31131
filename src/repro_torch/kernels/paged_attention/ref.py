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
