"""Wrapper of the CUDA paged GQA attention kernel (csrc/paged_attention.cu),
the port of the Pallas TPU kernel `paged_prefill_gqa`
(repro/kernels/paged_attention/paged_attention.py:105) and of its
chunk-of-1 decode wrapper `paged_decode_gqa` (:153).

`paged_prefill_gqa(..., backend=)` follows kernels/backend.py: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version `paged_prefill_gqa_ref`. `paged_prefill_gqa.launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import kernel_span, use_kernel
from repro_torch.kernels.build import check, library
from repro_torch.kernels.paged_attention.ref import paged_prefill_gqa_ref

OP = "paged_prefill_gqa"


@functools.cache
def _entry():
    """(kernel entry, shared-memory size query) with their C signatures."""
    lib = library("paged_attention")
    smem = lib.paged_prefill_gqa_smem
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    fn = lib.paged_prefill_gqa
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn, smem


def _launch(q, pool_k, pool_v, tables, past_len, lengths) -> torch.Tensor:
    b, c, kv, g, hd = q.shape
    nblk, bs = pool_k.shape[0], pool_k.shape[1]
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
    fn, smem_of = _entry()
    smem = smem_of(c * g, hd)
    L.require(smem <= L.MAX_SMEM, OP,
              f"{c}x{g} query rows of width {hd} need {smem} B of shared memory")
    out = torch.empty_like(q)
    err = fn(L.ptr(q), L.ptr(pool_k), L.ptr(pool_v), L.ptr(tables), L.ptr(past_len),
             L.ptr(lengths), L.ptr(out), b, c, kv, g, hd, bs, tables.shape[1],
             hd ** -0.5, code, L.stream(q))
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
