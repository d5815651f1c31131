"""Wrappers of the CUDA paged attention kernels:

- csrc/paged_attention.cu, the port of the Pallas TPU kernel
  `paged_prefill_gqa` (repro/kernels/paged_attention/paged_attention.py:105)
  and of its chunk-of-1 decode wrapper `paged_decode_gqa` (:153): bf16
  on wgmma over gathered 64-key tiles, split over the keys (and a combine
  launch) when the table is long; fp32 on the CUDA-core kernel;
- csrc/paged_attention_mla.cu, the port of `paged_prefill_mla` (:219)
  and of its chunk-of-1 decode wrapper `paged_decode_mla` (:269): bf16
  pools on wgmma with split-bf16 operands (q in three terms, P in two), each
  product with a latent exact in fp32, a cluster of two
  CTAs per 64 query rows, split over the keys (and a combine launch) when
  the table is long; fp32 pools on the CUDA-core kernel.

Each wrapper follows kernels/backend.py: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version of ref.py.
`paged_prefill_gqa.launches` and `paged_prefill_mla.launches` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import kernel_span, use_kernel
from repro_torch.kernels.build import check, library
from repro_torch.kernels.paged_attention.ref import (
    paged_prefill_gqa_ref,
    paged_prefill_mla_ref,
)

OP = "paged_prefill_gqa"
OP_MLA = "paged_prefill_mla"
BF16_HEAD_DIMS = (64, 128)  # the bf16 GQA kernel's instances
BF16_QUERY_ROWS = 64  # query rows of one bf16 block (MLA: cluster): one wgmma M tile
# blocks a SM the key splits aim for. GQA (row, head, query tile, key
# split) blocks: a block's gather waits on memory, so several a SM hide
# its latency (decode over 4096 keys: 1 a SM 0.0448 ms, PERF.md, PR 14).
# MLA clusters of two CTAs: a CTA takes most of an SM's shared memory, so
# one wave of CTAs is all that runs at once.
GQA_BLOCKS_PER_SM = 4
MLA_CLUSTERS_PER_SM = 0.5


@functools.cache
def _entry():
    """(kernel entry, fp32 shared-memory size query, bf16 keys per tile)."""
    lib = library("paged_attention")
    smem = lib.paged_prefill_gqa_smem
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    key_tile = lib.paged_prefill_gqa_key_tile
    key_tile.restype = ctypes.c_int
    key_tile.argtypes = []
    fn = lib.paged_prefill_gqa
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn, smem, key_tile()


def key_splits(blocks: int, key_tiles: int, n_sm: int, per_sm: float) -> int:
    """Key splits of a bf16 paged attention grid of `blocks` blocks a
    split (GQA: (row, head, query tile); MLA: (row, query tile)
    clusters): as many as keep the grid within `per_sm` blocks a SM, with
    room for at least two key tiles a split in the table (a split of one
    tile costs the combine more than it saves). The kernel divides the
    tiles each row walks (csrc/key_splits.cuh)."""
    return max(1, min(key_tiles // 2, int(per_sm * n_sm) // blocks))


def _launch(q, pool_k, pool_v, tables, past_len, lengths, splits=None) -> torch.Tensor:
    """`splits`: the bf16 grid's key splits, by default `key_splits`
    (chip_smoke.py times 1 beside it)."""
    b, c, kv, g, hd = q.shape
    nblk, bs = pool_k.shape[0], pool_k.shape[1]
    nb = tables.shape[1]
    L.same_device(OP, q, pool_k, pool_v, tables, past_len, lengths)
    code = L.dtype_code(q, OP)
    L.require(pool_k.dtype == q.dtype and pool_v.dtype == q.dtype, OP,
              "q and the pools must share a dtype")
    L.require(pool_k.shape == (nblk, bs, kv, hd) and pool_v.shape == pool_k.shape,
              OP, f"pools {tuple(pool_k.shape)} do not match q {tuple(q.shape)}")
    L.require(tables.dim() == 2 and tables.shape[0] == b, OP, "tables must be [B, nb]")
    for name, t in (("tables", tables), ("past_len", past_len), ("lengths", lengths)):
        L.require(t.dtype == torch.int32, OP, f"{name} must be int32")
    L.require(past_len.shape == (b,) and lengths.shape == (b,), OP,
              "past_len and lengths must be [B]")
    for t in (q, pool_k, pool_v, tables, past_len, lengths):
        L.require(t.is_contiguous(), OP, "all inputs must be contiguous")
    fn, smem_of, key_tile = _entry()
    part_o, part_ml = None, None
    if code == 0:
        splits = 1
        smem = smem_of(c * g, hd)
        L.require(smem <= L.MAX_SMEM, OP,
                  f"{c}x{g} query rows of width {hd} need {smem} B of shared memory a block")
    else:
        L.require(hd in BF16_HEAD_DIMS, OP,
                  f"bf16 head width {hd} not in {BF16_HEAD_DIMS}")
        if splits is None:
            n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
            pairs = b * kv * -(-(c * g) // BF16_QUERY_ROWS)
            splits = key_splits(pairs, -(-(nb * bs) // key_tile), n_sm, GQA_BLOCKS_PER_SM)
        if splits > 1:
            part_o = torch.empty((splits, b, kv, c * g, hd), dtype=torch.float32,
                                 device=q.device)
            part_ml = torch.empty((splits, b, kv, c * g, 2), dtype=torch.float32,
                                  device=q.device)
    out = torch.empty_like(q)
    err = fn(L.ptr(q), L.ptr(pool_k), L.ptr(pool_v), L.ptr(tables), L.ptr(past_len),
             L.ptr(lengths), L.ptr(out),
             *(L.ptr(t) if t is not None else None for t in (part_o, part_ml)),
             b, c, kv, g, hd, bs, nb, splits, hd ** -0.5, code, L.stream(q))
    check(err, OP)
    paged_prefill_gqa.launches += 1
    return out


def paged_prefill_gqa(q, pool_k, pool_v, tables, past_len, lengths, *,
                      backend: str = "auto") -> torch.Tensor:
    """q: [B, C, Kv, G, hd] a chunk of query tokens; pools [N+1, bs, Kv,
    hd] (last block = write trash); tables [B, nb] int32; past_len [B]
    int32 tokens cached before the chunk; lengths [B] int32 real tokens
    in the chunk -> [B, C, Kv, G, hd] in q's dtype."""
    if use_kernel(backend, q, op=OP):
        with kernel_span(OP, "cuda"):
            return _launch(q, pool_k, pool_v, tables, past_len, lengths)
    with kernel_span(OP, "ref"):
        return paged_prefill_gqa_ref(q, pool_k, pool_v, tables, past_len, lengths)


paged_prefill_gqa.launches = 0


def paged_decode_gqa(q, pool_k, pool_v, tables, pos, *, backend: str = "auto"):
    """Decode = chunk of 1: q [B, Kv, G, hd] at `pos` [B] sees every
    kpos <= pos, i.e. `past_len = pos, lengths = 1`."""
    pos = pos.to(torch.int32)
    return paged_prefill_gqa(
        q[:, None].contiguous(), pool_k, pool_v, tables, pos, torch.ones_like(pos),
        backend=backend,
    )[:, 0]


# ------------------------------------------------------------------- MLA
# the bf16 MLA kernel's widths: latent rank and rope width multiples of 8
# (16-byte pieces), the rope width at most one 64-column chunk
MLA_BF16_MAX_ROPE = 64


@functools.cache
def _mla_entry():
    """(kernel entry, fp32 shared-memory size query, widest latent rank,
    bf16 keys per tile)."""
    lib = library("paged_attention_mla")
    smem = lib.paged_prefill_mla_smem
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    max_rank = lib.paged_prefill_mla_max_rank
    max_rank.restype = ctypes.c_int
    max_rank.argtypes = []
    key_tile = lib.paged_prefill_mla_key_tile
    key_tile.restype = ctypes.c_int
    key_tile.argtypes = []
    fn = lib.paged_prefill_mla
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn, smem, max_rank(), key_tile()


def _launch_mla(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths,
                scale: float, splits=None) -> torch.Tensor:
    """`splits`: the bf16 grid's key splits, by default `key_splits`
    (chip_smoke.py times 1 beside it)."""
    b, c, h, r = q_lat.shape
    rd = q_rope.shape[-1]
    nblk, bs = pool_ckv.shape[0], pool_ckv.shape[1]
    nb = tables.shape[1]
    L.same_device(OP_MLA, q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths)
    L.require(q_lat.dtype == torch.float32 and q_rope.dtype == torch.float32, OP_MLA,
              "q_lat and q_rope must be float32")
    code = L.dtype_code(pool_ckv, OP_MLA)
    L.require(pool_krope.dtype == pool_ckv.dtype, OP_MLA, "the pools must share a dtype")
    L.require(q_rope.shape == (b, c, h, rd), OP_MLA,
              f"q_rope {tuple(q_rope.shape)} does not match q_lat {tuple(q_lat.shape)}")
    L.require(pool_ckv.shape == (nblk, bs, r) and pool_krope.shape == (nblk, bs, rd),
              OP_MLA, f"pools {tuple(pool_ckv.shape)}, {tuple(pool_krope.shape)} do not "
                      f"match q_lat {tuple(q_lat.shape)} and q_rope {tuple(q_rope.shape)}")
    L.require(tables.dim() == 2 and tables.shape[0] == b, OP_MLA, "tables must be [B, nb]")
    for name, t in (("tables", tables), ("past_len", past_len), ("lengths", lengths)):
        L.require(t.dtype == torch.int32, OP_MLA, f"{name} must be int32")
    L.require(past_len.shape == (b,) and lengths.shape == (b,), OP_MLA,
              "past_len and lengths must be [B]")
    for t in (q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths):
        L.require(t.is_contiguous(), OP_MLA, "all inputs must be contiguous")
    fn, smem_of, max_rank, key_tile = _mla_entry()
    L.require(r <= max_rank, OP_MLA, f"latent rank {r} above the kernel's {max_rank}")
    part_o, part_ml = None, None
    if code == 0:
        splits = 1
        smem = smem_of(r, rd)
        L.require(smem <= L.MAX_SMEM, OP_MLA,
                  f"latent width {r} + {rd} needs {smem} B of shared memory")
    else:
        L.require(r % 8 == 0 and rd % 8 == 0 and rd <= MLA_BF16_MAX_ROPE, OP_MLA,
                  f"bf16 latent rank {r} and rope width {rd} must be multiples of 8, "
                  f"the rope width at most {MLA_BF16_MAX_ROPE}")
        L.require(all(t.data_ptr() % 16 == 0 for t in (q_lat, q_rope, pool_ckv, pool_krope)),
                  OP_MLA, "q and the pools must be 16-byte aligned")
        if splits is None:
            n_sm = torch.cuda.get_device_properties(q_lat.device).multi_processor_count
            clusters = b * -(-(c * h) // BF16_QUERY_ROWS)
            splits = key_splits(clusters, -(-(nb * bs) // key_tile), n_sm,
                                MLA_CLUSTERS_PER_SM)
        if splits > 1:
            part_o = torch.empty((splits, b, c * h, r), dtype=torch.float32,
                                 device=q_lat.device)
            part_ml = torch.empty((splits, b, c * h, 2), dtype=torch.float32,
                                  device=q_lat.device)
    out = torch.empty_like(q_lat)
    err = fn(L.ptr(q_lat), L.ptr(q_rope), L.ptr(pool_ckv), L.ptr(pool_krope),
             L.ptr(tables), L.ptr(past_len), L.ptr(lengths), L.ptr(out),
             *(L.ptr(t) if t is not None else None for t in (part_o, part_ml)),
             b, c, h, r, rd, bs, nb, splits, scale, code, L.stream(q_lat))
    check(err, OP_MLA)
    paged_prefill_mla.launches += 1
    return out


def paged_prefill_mla(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths, *,
                      scale: float, backend: str = "auto") -> torch.Tensor:
    """Absorbed MLA attention of a chunk over latent pools. q_lat [B, C, H,
    r] and q_rope [B, C, H, rd] fp32; pools [N+1, bs, r] and [N+1, bs, rd]
    in the param dtype (last block = write trash); tables [B, nb] int32;
    past_len / lengths [B] int32 as in `paged_prefill_gqa`; `scale` is
    (qk_nope + qk_rope) ** -0.5 -> o_lat [B, C, H, r] fp32."""
    if use_kernel(backend, q_lat, op=OP_MLA):
        with kernel_span(OP_MLA, "cuda"):
            return _launch_mla(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len,
                               lengths, scale)
    with kernel_span(OP_MLA, "ref"):
        return paged_prefill_mla_ref(q_lat, q_rope, pool_ckv, pool_krope, tables,
                                     past_len, lengths, scale=scale)


paged_prefill_mla.launches = 0


def paged_decode_mla(q_lat, q_rope, pool_ckv, pool_krope, tables, pos, *,
                     scale: float, backend: str = "auto"):
    """Decode = chunk of 1: q_lat [B, H, r], q_rope [B, H, rd] at `pos`
    [B] -> o_lat [B, H, r] fp32 (`past_len = pos, lengths = 1`)."""
    pos = pos.to(torch.int32)
    return paged_prefill_mla(
        q_lat[:, None].contiguous(), q_rope[:, None].contiguous(), pool_ckv, pool_krope,
        tables, pos, torch.ones_like(pos), scale=scale, backend=backend,
    )[:, 0]
