"""GQA and MLA attention (port of repro/models/attention.py: `init_gqa`
:38, `init_mla` :56, `_grouped_attention` :75, `gqa_forward` :180 (with
cross attention's `kv_override` and the encoder's causal=False),
`gqa_decode` :211, `mla_forward` :242, `mla_decode` :292, `_paged_write`
:364, `paged_scatter` :374, `gqa_decode_paged` :390, `mla_decode_paged`
:438, `gqa_prefill_paged` :495, `mla_prefill_paged` :552).

Two cache layouts. The contiguous one ("slots") holds a ring buffer of
static length S per row: `gqa_forward` / `mla_forward` run whole
sequences (prefill) and return the tokens' cache entries, `gqa_decode` /
`mla_decode` write one token per row at `pos % S` (in place) and attend
over the row's valid slots. These are plain PyTorch, as the reference's
are plain jnp (they reach no Pallas kernel); `_grouped_attention` is the
reference's query-chunked exact softmax. Under `set_sequence_parallel`
(reference :29-34, :145-177) full-sequence causal self-attention splits
its query rows over a mesh dim: each rank attends its S/m rows over the
whole K/V and the rows are gathered again, and MLA then runs absorbed
(:267), attending over the latents.

K/V (GQA) and the MLA latents live in shared block pools [N+1, bs, ...]
whose last block is the write trash: pad rows and dead rows write there,
never into a (possibly shared) live block. The pools are updated IN PLACE
(the JAX functions return new pools; here the same tensors come back,
written), which saves a copy of every pool per layer per step. The
attention itself is the paged-attention kernel family
(kernels/paged_attention), decode being its chunk-of-1 case; each call
is a `kernel.<op>` span under the reference's name for it.

MLA runs absorbed: W_k^nope is folded into the query (`q_lat`), the
kernel attends over the latent pools and returns latent outputs, and the
W_v expansion and output projection stay out here. Those latent
contractions run in fp32 (the operands are cast first; TF32 stays off),
as the reference's `preferred_element_type=f32`: a bf16 accumulation
over the kv_lora_rank-wide latent drifts decode measurably.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import copy_to_group, gather_dim
from repro_torch.kernels.backend import kernel_span
from repro_torch.kernels.paged_attention import (
    paged_decode_gqa,
    paged_decode_mla,
    paged_prefill_gqa,
    paged_prefill_mla,
)
from repro_torch.configs.base import refuse_on_mesh
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    init_rmsnorm,
    rmsnorm,
    torch_dtype,
    yarn_mscale,
)

NEG_INF = -1e30

# sequence-parallel attention: (mesh, axis, dp axes) | None
_SEQ_PARALLEL = None


def set_sequence_parallel(mesh, axis: str = "model", dp=("data",)):
    """Split full-sequence causal self-attention's query rows over the mesh
    dim `axis` (None turns it off). `dp` names the axes the batch rows are
    split over; each rank already holds its own rows here."""
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = (mesh, axis, dp) if mesh is not None else None


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
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:  # q: down to the q latent, RMSNorm, up to nope + rope per head
        p = {"wq_a": dense_init(gen, (d, m.q_lora_rank), dt, lead=lead),
             "q_norm": init_rmsnorm(m.q_lora_rank, dt, gen.device, lead),
             "wq_b": dense_init(gen, (m.q_lora_rank, h, dq), dt, lead=lead)}
    else:  # q: direct projection to nope + rope dims per head
        p = {"wq": dense_init(gen, (d, h, dq), dt, lead=lead)}
    # kv_a: down-projection to the latent + the shared rope key
    p["wkv_a"] = dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dt, lead=lead)
    if m.kv_norm:
        p["kv_norm"] = init_rmsnorm(m.kv_lora_rank, dt, gen.device, lead)
    # kv_b: latent -> per-head (k_nope, v)
    p["wkv_b"] = dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim),
                            dt, lead=lead)
    p["wo"] = dense_init(gen, (h, m.v_head_dim, d), dt, lead=lead)
    return p


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
                       q_chunk: int = 1024, q_offset=None, seq_parallel: bool = True,
                       scale=None):
    """q [B, Sq, H, hd]; k / v [B, Sk, Kv, hd_{k,v}] -> [B, Sq, H, hd_v].

    Exact softmax per query row, over query chunks of `q_chunk` rows so the
    score tensor never exceeds one chunk. Causal: query i sits at absolute
    position i + (Sk - Sq), or q_offset + i when `q_offset` is given (a
    sequence-parallel shard). `valid`: optional [Sk] or [B, Sk] bool of
    usable keys (pad keys of a masked prefill, a decode ring's filled
    slots). Scores are taken in the inputs' dtype and then scaled in fp32;
    the softmax is fp32 and cast to v's dtype for the value product, as in
    the reference. `seq_parallel=False` keeps `set_sequence_parallel` out
    (the mesh path decides its own split: `_mesh_attention`). `scale`
    replaces the scores' hd^-0.5."""
    if (seq_parallel and _SEQ_PARALLEL is not None and causal and q_offset is None
            and valid is None and q.shape[1] == k.shape[1]):
        sp = _seq_parallel_attention(q, k, v, q_chunk=q_chunk, scale=scale)
        if sp is not None:
            return sp
    b, sq, h, hdk = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hdk)
    scale = hdk ** -0.5 if scale is None else scale
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
            base = q_offset if q_offset is not None else (sk - sq)
            qpos = start + torch.arange(qc.shape[1], device=q.device) + base
            mask = (kpos[None, :] <= qpos[:, None])[None]  # [1, C, Sk]
        if vmask is not None:
            mask = vmask if mask is None else (mask & vmask)
        if mask is not None:
            s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bckgs,bskd->bckgd", p.to(v.dtype), v))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, sq, h, -1)


def _seq_parallel_attention(q, k, v, *, q_chunk: int, scale=None):
    """Causal self-attention with the query rows split over the mesh dim:
    this rank's S/m rows against the whole K/V, then the rows gathered
    in rank order. Each rank's rows give a part of q's, k's and v's
    gradients, which the backward sums over the dim. None when S does
    not divide (the caller runs the replicated path)."""
    mesh, axis, _ = _SEQ_PARALLEL
    group, m, idx = shd.axis_group(mesh, axis)
    sq = q.shape[1]
    if sq % m:
        return None
    n = sq // m
    q, k, v = (copy_to_group(t, group) for t in (q, k, v))
    out = _grouped_attention(q[:, idx * n:(idx + 1) * n], k, v, causal=True,
                             q_chunk=min(q_chunk, n), q_offset=idx * n, scale=scale)
    return gather_dim(out, group, 1)


# ---------------------------------------------- contiguous (slots) layout
def gqa_forward(p: Params, cfg, x, positions, token_mask=None, *, kv_override=None,
                causal=True):
    """Full-sequence GQA (prefill, training, an encoder's self-attention
    with causal=False, cross attention). x [B, S, D]; positions [B or 1,
    S]; token_mask [B, S] real tokens (pad keys masked; outputs at pad
    queries are unspecified). With `kv_override` (k, v) [B, Sk, Kv, hd]
    only q is projected (its bias added) and nothing is roped: cross
    attention over an encoder's K/V. Returns (out [B, S, D], (k, v)) with
    the tokens' k / v [B, S, Kv, hd] for the cache."""
    if kv_override is None:
        q, k, v = _qkv(p, x, positions, cfg.rope_theta)
    else:
        k, v = kv_override
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
    out = _grouped_attention(q, k, v, causal=causal, valid=token_mask)
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
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv, krope = _mla_kv(p, cfg, x, positions)
    krope = krope[:, :, None, :]  # [B, S, 1, rd]
    if _SEQ_PARALLEL is not None:
        # absorbed: attend over the latent (r + rd wide) instead of the
        # expanded per-head K/V (reference :267)
        wk_b, wv_b = p["wkv_b"].split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)
        q_eff = torch.cat([q_lat, q_rope], dim=-1)  # [B, S, H, r + rd]
        k_eff = torch.cat([ckv[:, :, None, :], krope], dim=-1)
        # _grouped_attention scales by (r + rd)^-0.5; correct it to d_qk^-0.5
        d_qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        q_eff = q_eff * ((m.kv_lora_rank + m.qk_rope_head_dim) / d_qk) ** 0.5
        if m.yarn is not None:
            q_eff = q_eff * yarn_mscale(m.yarn.factor, m.yarn.mscale_all_dim) ** 2
        o_lat = _grouped_attention(q_eff, k_eff, ckv[:, :, None, :], causal=True,
                                   valid=token_mask)  # [B, S, H, r]
        out = torch.einsum("bshr,rhk->bshk", o_lat, wv_b)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (ckv, krope[:, :, 0, :])
    kvb = torch.einsum("bsr,rhk->bshk", ckv, p["wkv_b"])
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, krope.expand(*k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = _grouped_attention(qf, k, v, causal=True, valid=token_mask, scale=_mla_scale(cfg))
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
    with kernel_span("paged_decode_gqa", qk, tables):
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
    with kernel_span("paged_prefill_gqa", qk, tables):
        out = paged_prefill_gqa(qk, pool_k, pool_v, tables, past_len, lengths,
                                backend=cfg.paged_attn_backend)
    out = out.reshape(b, c, q.shape[2], q.shape[3]).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), pool_k, pool_v


def _mla_q(p: Params, cfg, x, positions):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rd] roped) of x [B, S, D]:
    the direct projection, or with `q_lora_rank` x wq_a, RMSNorm, wq_b."""
    m = cfg.mla
    if m.q_lora_rank:
        qa = rmsnorm(p["q_norm"], torch.einsum("bsd,dr->bsr", x, p["wq_a"]), cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", qa, p["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta, m.yarn)


def _mla_kv(p: Params, cfg, x, positions):
    """The tokens' cache entries of x [B, S, D]: (ckv [B, S, r], through
    RMSNorm with `kv_norm`; krope [B, S, rd] roped)."""
    m = cfg.mla
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv, krope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    if m.kv_norm:
        ckv = rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    krope = apply_rope(krope[:, :, None, :], positions, cfg.rope_theta, m.yarn)[:, :, 0, :]
    return ckv, krope


def _mla_project(p: Params, cfg, x, positions):
    """Absorbed MLA projections of x [B, S, D] at `positions` [B, S]:
    (q_lat [B, S, H, r] fp32, q_rope [B, S, H, rd] fp32, ckv_new [B, S, r],
    krope_new [B, S, rd], wv_b [r, H, v])."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv_new, krope_new = _mla_kv(p, cfg, x, positions)
    wk_b, wv_b = p["wkv_b"].split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(), wk_b.float())
    return q_lat.contiguous(), q_rope.float().contiguous(), ckv_new, krope_new, wv_b


def _mla_out(p: Params, o_lat, wv_b, dtype):
    """Latent outputs o_lat [B, S, H, r] fp32 -> [B, S, D]: the W_v
    expansion in fp32, cast to the activation dtype, then wo."""
    o = torch.einsum("bshr,rhk->bshk", o_lat, wv_b.float()).to(dtype)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _mla_scale(cfg) -> float:
    """The scores' scale: d_qk^-0.5, under YaRN times mscale(factor,
    mscale_all_dim)^2 (1.874 at DeepSeek-V3's factor 40)."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if m.yarn is not None:
        scale *= yarn_mscale(m.yarn.factor, m.yarn.mscale_all_dim) ** 2
    return scale


def mla_decode_paged(p: Params, cfg, x, pool_ckv, pool_krope, tables, pos):
    """Absorbed one-token MLA decode against paged latent pools. x [B, 1,
    D]; pool_ckv [N+1, bs, r]; pool_krope [N+1, bs, rd]; tables [B, nb]
    int32; pos [B] int32. The new token's latents are written first, then
    the kernel attends in latent space. Returns (out [B, 1, D], pool_ckv,
    pool_krope)."""
    q_lat, q_rope, ckv_new, krope_new, wv_b = _mla_project(p, cfg, x, pos[:, None])
    _paged_write(pool_ckv, tables, pos, ckv_new[:, 0])
    _paged_write(pool_krope, tables, pos, krope_new[:, 0])
    with kernel_span("paged_decode_mla", q_lat, tables):
        o_lat = paged_decode_mla(q_lat[:, 0], q_rope[:, 0], pool_ckv, pool_krope, tables,
                                 pos, scale=_mla_scale(cfg), backend=cfg.paged_attn_backend)
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
    with kernel_span("paged_prefill_mla", q_lat, tables):
        o_lat = paged_prefill_mla(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len,
                                  lengths, scale=_mla_scale(cfg),
                                  backend=cfg.paged_attn_backend)
    return _mla_out(p, o_lat, wv_b, x.dtype), pool_ckv, pool_krope


# ------------------------------------------------------ on a device mesh
# The contiguous layout on a mesh (`tp`, distributed/tensor_parallel.py):
# heads tensor-parallel by the reference's rules (wq / wk / wv over heads,
# wo row-parallel; where the heads do not divide "model" the contracting
# D instead, its partial sums summed), the cache split by `cache_pspec`:
# rows over the DP axes, keys (ring slots) over "model". Prefill writes
# its K/V head-sharded and reshards them to key shards (one all-to-all);
# decode attends every head over this rank's key shard and combines the
# shards by log-sum-exp over "model" (flash-decoding across ranks),
# gathering no cache shard.
def _seq_split(cache) -> bool:
    """Whether "model" splits the cache's keys (dim 1 of [B, S, ...])."""
    return cache.axes.get("model") == 1


def _key_shard(tp, cache, pos):
    """(first ring slot of this rank's keys, [B, T] valid keys): the slots
    filled so far (slot <= pos), as `gqa_decode` masks them."""
    n = cache.t.shape[1]
    lo = tp.mi * n if _seq_split(cache) else 0
    slots = lo + torch.arange(n, device=pos.device)
    return lo, slots[None, :] <= pos[:, None]


def _ring_write_mesh(tp, cache, pos, val):
    """val [B, ...] at ring slot pos % S of each row, in place, on the
    model rank whose key shard holds the slot (the others keep theirs)."""
    c = cache.t
    slot = (pos % cache.shape[1]).long()
    rows = torch.arange(c.shape[0], device=c.device)
    if not _seq_split(cache):
        c[rows, slot] = val
        return
    n = c.shape[1]
    rel = slot - tp.mi * n
    mine = ((rel >= 0) & (rel < n)).reshape(-1, *([1] * (val.ndim - 1)))
    rel = rel.clamp(0, n - 1)
    c[rows, rel] = torch.where(mine, val.to(c.dtype), c[rows, rel])


def _attend_lse(q, k, v, valid):
    """q [B, Sq, H, hd] (a decode step's one query a row, or cross
    attention's Sq) over k / v [B, T, Kv, hd] (this rank's keys), valid
    [B, T] -> (out [B, Sq, H, hd_v] in v's dtype, lse [B, Sq, H] fp32),
    the softmax as `_grouped_attention` takes it."""
    b, sq, h, hdk = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hdk)
    s = torch.einsum("bckgd,bskd->bckgs", qg, k).float() * hdk ** -0.5
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bckgs,bskd->bckgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, -1), torch.logsumexp(s, dim=-1).reshape(b, sq, h)


def _combine(tp, out, lse):
    """Each rank's softmax over its keys, weighted by exp(lse - max lse)
    and summed over "model": the softmax over every key. out [..., H, k],
    lse [..., H]."""
    w = torch.exp(lse - tp.max_model(lse))[..., None]
    tot = tp.sum_model(torch.cat([out.float() * w, w], dim=-1))
    return (tot[..., :-1] / tot[..., -1:]).to(out.dtype)


def fill_seq_cache(tp, cache, val, heads_lo, token_mask):
    """Prefill's entries val [B, s, ...] (s <= S) at the head of the rows'
    fresh cache [B, S, ...], pads zeroed, in the cache's layout. Entries
    computed head-sharded (`heads_lo` not None: this rank's KV heads along
    dim 2) are resharded from heads to key shards by one all-to-all over
    "model" (gathered over heads when the keys are not split); whole ones
    are cut to this rank's keys."""
    c = cache.t
    b, s = val.shape[:2]
    big = cache.shape[1]
    if s > big:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of {big}")
    if token_mask is not None:
        val = val * token_mask[(...,) + (None,) * (val.ndim - 2)].to(val.dtype)
    split = _seq_split(cache)
    if heads_lo is not None and split:
        full = val.new_zeros((b, big, *val.shape[2:]))
        full[:, :s] = val
        n = big // tp.m
        parts = full.reshape(b, tp.m, n, *val.shape[2:]).movedim(1, 0)  # [m, B, n, Kv/m, ..]
        got = tp.all_to_all_model(parts)  # part j: rank j's heads of this rank's keys
        c.copy_(got.movedim(0, 2).reshape(c.shape))
        return
    if heads_lo is not None:
        val = tp.gather_model(val, 2)
    if split:
        n = c.shape[1]
        lo = tp.mi * n
        hi = min(lo + n, s)
        if hi > lo:
            c[:, :hi - lo] = val[:, lo:hi]
    else:
        c[:, :s] = val


def _kv_for_heads(tp, q_lo, nq, k, v, k_lo, cfg):
    """K / V of this rank's query heads [q_lo, q_lo + nq): the local KV
    heads when both split, the groups they read (or, where the rank's
    heads cut a group, one KV head per query head) when only q does (K /
    V whole on every rank then enter rank-specific compute)."""
    if q_lo is None:
        if k_lo is not None:
            raise ValueError("KV heads split over 'model' but query heads whole")
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    if k_lo is not None:
        if k_lo != q_lo // g or k.shape[2] * g != nq:
            raise ValueError(f"query heads from {q_lo} do not read KV heads from {k_lo}")
        return k, v
    k, v = tp.copy_model(k), tp.copy_model(v)
    if q_lo % g == 0 and nq % g == 0:
        return k.narrow(2, q_lo // g, nq // g), v.narrow(2, q_lo // g, nq // g)
    idx = (q_lo + torch.arange(nq, device=k.device)) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _qkv_mesh(tp, p, x, positions, theta):
    from repro_torch.distributed import tensor_parallel as tpl

    eq = "bsd,dhk->bshk"
    q, q_lo = tpl.heads_proj(tp, x, p["wq"], eq, p.get("bq"))
    k, k_lo = tpl.heads_proj(tp, x, p["wk"], eq, p.get("bk"))
    v, v_lo = tpl.heads_proj(tp, x, p["wv"], eq, p.get("bv"))
    if k_lo != v_lo:
        raise ValueError(f"wk and wv split apart: {p['wk'].axes}, {p['wv'].axes}")
    return apply_rope(q, positions, theta), q_lo, apply_rope(k, positions, theta), v, k_lo


def _mesh_attention(tp, q, q_lo, k, v, causal, valid):
    """`_grouped_attention` of this rank's heads of q over k / v (the
    same heads' K / V). With every head on every rank (q_lo None: heads
    that do not divide "model") the query rows split over "model" instead
    where they divide it, as the reference's shard_map splits them: this
    rank's S/m rows against the whole K / V, then the rows gathered."""
    s = q.shape[1]
    if not (q_lo is None and tp.m > 1 and s % tp.m == 0):
        return _grouped_attention(q, k, v, causal=causal, valid=valid, seq_parallel=False)
    n = s // tp.m
    q, k, v = (tp.copy_model(t) for t in (q, k, v))
    out = _grouped_attention(q.narrow(1, tp.mi * n, n), k, v, causal=causal, valid=valid,
                             q_chunk=min(1024, n), q_offset=tp.mi * n, seq_parallel=False)
    return tp.gather_model(out, 1)


def gqa_prefill_mesh(tp, p, cfg, x, positions, token_mask, cache_k=None, cache_v=None,
                     causal=True):
    """`gqa_forward` (masked) on a mesh, its K/V written into the rows'
    sharded cache (`fill_seq_cache`); with no cache (an encoder's self-
    attention, causal=False, or training) nothing is written. x [B, S, D]
    this rank's rows; p's leaves `Local`. Returns out [B, S, D]."""
    from repro_torch.distributed import tensor_parallel as tpl

    q, q_lo, k, v, k_lo = _qkv_mesh(tp, p, x, positions, cfg.rope_theta)
    ka, va = _kv_for_heads(tp, q_lo, q.shape[2], k, v, k_lo, cfg)
    out = _mesh_attention(tp, q, q_lo, ka, va, causal, token_mask)
    if cache_k is not None:
        fill_seq_cache(tp, cache_k, k, k_lo, token_mask)
        fill_seq_cache(tp, cache_v, v, k_lo, token_mask)
    return tpl.heads_out(tp, out, q_lo, p["wo"], "bshk,hkd->bsd")


def gqa_decode_mesh(tp, p, cfg, x, cache_k, cache_v, pos):
    """`gqa_decode` on a mesh: the new token's q / k / v gathered to every
    head (a row's few values), its K/V written on the rank owning slot
    pos % S, every head attended over this rank's keys and the shards
    combined over "model", then wo. Returns out [B, 1, D]."""
    from repro_torch.distributed import tensor_parallel as tpl

    q, q_lo, k, v, k_lo = _qkv_mesh(tp, p, x, pos[:, None], cfg.rope_theta)
    q = tpl.gather_heads(tp, q, q_lo)
    _ring_write_mesh(tp, cache_k, pos, tpl.gather_heads(tp, k, k_lo)[:, 0])
    _ring_write_mesh(tp, cache_v, pos, tpl.gather_heads(tp, v, k_lo)[:, 0])
    _, valid = _key_shard(tp, cache_k, pos)
    out, lse = _attend_lse(q, cache_k.t, cache_v.t, valid)
    if _seq_split(cache_k):
        out = _combine(tp, out, lse)
    return tpl.heads_out(tp, out, None, p["wo"], "bshk,hkd->bsd")


def _mla_latents_mesh(tp, p, cfg, x, positions):
    """(q_nope, q_rope (roped), q's first head or None, ckv [B, S, r],
    krope [B, S, rd] (roped)): wq over heads, wkv_a column-parallel over
    its r + rd outputs (gathered: every rank needs the whole latent)."""
    from repro_torch.distributed import tensor_parallel as tpl

    refuse_on_mesh(cfg, "MLA")
    m = cfg.mla
    q, q_lo = tpl.heads_proj(tp, x, p["wq"], "bsd,dhk->bshk")
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = tpl.out_proj(tp, x, p["wkv_a"], eq="bsd,dr->bsr")
    ckv, krope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    krope = apply_rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, q_lo, ckv, krope


def mla_prefill_mesh(tp, p, cfg, x, positions, token_mask, cache_ckv=None, cache_krope=None):
    """`mla_forward` (expanded) on a mesh: this rank's heads of q and of
    wkv_b's per-head K/V, wo row-parallel; the latents (whole on every
    rank) cut to this rank's key shard of the cache (with no cache, as
    training runs, nothing is written). Returns out [B, S, D]."""
    from repro_torch.distributed import tensor_parallel as tpl

    m = cfg.mla
    q_nope, q_rope, q_lo, ckv, krope = _mla_latents_mesh(tp, p, cfg, x, positions)
    kvb, kv_lo = tpl.heads_proj(tp, ckv, p["wkv_b"], "bsr,rhk->bshk")
    if kv_lo != q_lo:
        raise ValueError(f"wq and wkv_b split apart: {p['wq'].axes}, {p['wkv_b'].axes}")
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    kr = krope if q_lo is None else tp.copy_model(krope)  # shared by this rank's heads
    k = torch.cat([k_nope, kr[:, :, None, :].expand(*k_nope.shape[:3],
                                                     m.qk_rope_head_dim)], dim=-1)
    out = _mesh_attention(tp, torch.cat([q_nope, q_rope], dim=-1), q_lo, k, v, True,
                          token_mask)
    if cache_ckv is not None:
        fill_seq_cache(tp, cache_ckv, ckv, None, token_mask)
        fill_seq_cache(tp, cache_krope, krope, None, token_mask)
    return tpl.heads_out(tp, out, q_lo, p["wo"], "bshk,hkd->bsd")


def mla_decode_mesh(tp, p, cfg, x, cache_ckv, cache_krope, pos):
    """`mla_decode` (absorbed) on a mesh: this rank's heads of q_lat =
    q_nope W_k^nope gathered to every head, the new latents written on the
    rank owning slot pos % S, scores and values over this rank's latent
    keys for every head (fp32), the shards combined over "model", then
    this rank's heads through W_v and wo (row-parallel). Returns out
    [B, 1, D]."""
    from repro_torch.distributed import tensor_parallel as tpl

    m = cfg.mla
    q_nope, q_rope, q_lo, ckv_new, krope_new = _mla_latents_mesh(tp, p, cfg, x, pos[:, None])
    wkv_b, dm, _ = tp.weight(p["wkv_b"])
    if (dm is None) != (q_lo is None):
        raise ValueError(f"wq and wkv_b split apart: {p['wq'].axes}, {p['wkv_b'].axes}")
    wk_b, wv_b = wkv_b.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(), wk_b.float())
    q_lat = tpl.gather_heads(tp, q_lat, q_lo)
    q_rope = tpl.gather_heads(tp, q_rope.float(), q_lo)
    _ring_write_mesh(tp, cache_ckv, pos, ckv_new[:, 0])
    _ring_write_mesh(tp, cache_krope, pos, krope_new[:, 0])
    ckv, krope = cache_ckv.t.float(), cache_krope.t.float()
    s = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
         + torch.einsum("bshk,btk->bhst", q_rope, krope)) * _mla_scale(cfg)
    _, valid = _key_shard(tp, cache_ckv, pos)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    o_lat = torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1), ckv)
    if _seq_split(cache_ckv):
        o_lat = _combine(tp, o_lat, torch.logsumexp(s, dim=-1).transpose(1, 2))
    if q_lo is not None:
        o_lat = o_lat.narrow(2, q_lo, wv_b.shape[1])
    o = torch.einsum("bshr,rhk->bshk", o_lat, wv_b.float()).to(x.dtype)
    return tpl.heads_out(tp, o, q_lo, p["wo"], "bshk,hkd->bsd")


# --------------------------------------- the encoder and cross attention
# seamless (16 MHA heads over "model"): the encoder's self-attention is
# `gqa_prefill_mesh` non-causal over no cache; cross attention projects q
# heads-parallel and reads the cross K/V ck / cv [B, F, Kv, hd], which
# `cache_pspec` splits over frames: K/V computed heads-parallel from the
# encoder output are resharded to frames by one all-to-all
# (`fill_seq_cache`), and the queries (S in prefill, 1 in decode) attend
# every head over this rank's frames, with no key and no causal mask,
# the frame shards combined by log-sum-exp over "model".
def fill_cross_mesh(tp, p, enc_out, cache_ck, cache_cv):
    """A decoder layer's cross K/V of the encoder output [B, F, D] (no bias,
    no RoPE), heads-parallel, written into the rows' frame shards."""
    from repro_torch.distributed import tensor_parallel as tpl

    eq = "bsd,dhk->bshk"
    k, k_lo = tpl.heads_proj(tp, enc_out, p["wk"], eq)
    v, v_lo = tpl.heads_proj(tp, enc_out, p["wv"], eq)
    if k_lo != v_lo:
        raise ValueError(f"wk and wv split apart: {p['wk'].axes}, {p['wv'].axes}")
    fill_seq_cache(tp, cache_ck, k, k_lo, None)
    fill_seq_cache(tp, cache_cv, v, v_lo, None)


def cross_attention_train_mesh(tp, p, cfg, x, enc_out):
    """Cross attention of x [B, S, D] over the encoder output [B, F, D]
    with no cache (training): q, K and V heads-parallel (K / V projected
    from `enc_out`, no bias, no RoPE), each rank's heads over every frame
    (or, where the heads do not divide, its query rows: `_mesh_attention`),
    then wo. Returns out [B, S, D]."""
    from repro_torch.distributed import tensor_parallel as tpl

    eq = "bsd,dhk->bshk"
    q, q_lo = tpl.heads_proj(tp, x, p["wq"], eq, p.get("bq"))
    k, k_lo = tpl.heads_proj(tp, enc_out, p["wk"], eq)
    v, v_lo = tpl.heads_proj(tp, enc_out, p["wv"], eq)
    if k_lo != v_lo:
        raise ValueError(f"wk and wv split apart: {p['wk'].axes}, {p['wv'].axes}")
    ka, va = _kv_for_heads(tp, q_lo, q.shape[2], k, v, k_lo, cfg)
    out = _mesh_attention(tp, q, q_lo, ka, va, False, None)
    return tpl.heads_out(tp, out, q_lo, p["wo"], "bshk,hkd->bsd")


def cross_attention_mesh(tp, p, cfg, x, cache_ck, cache_cv):
    """Cross attention of x [B, S, D] (no RoPE on q) over the cached
    encoder K/V: every head's queries over this rank's frames, the frame
    shards combined over "model", then wo. Returns out [B, S, D]."""
    from repro_torch.distributed import tensor_parallel as tpl

    q, q_lo = tpl.heads_proj(tp, x, p["wq"], "bsd,dhk->bshk", p.get("bq"))
    q = tpl.gather_heads(tp, q, q_lo)
    k, v = cache_ck.t, cache_cv.t
    every = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    out, lse = _attend_lse(q, k, v, every)
    if _seq_split(cache_ck):
        out = _combine(tp, out, lse)
    return tpl.heads_out(tp, out, None, p["wo"], "bshk,hkd->bsd")
