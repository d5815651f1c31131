"""Wrapper of the CUDA grouped expert GEMM (csrc/moe_gemm.cu), the port
of the Pallas TPU kernel `moe_gemm` (repro/kernels/moe_gemm/moe_gemm.py:34).

`moe_gemm(..., backend=)` follows kernels/backend.py: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs `moe_gemm_ref`.
`moe_gemm.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import kernel_span, use_kernel
from repro_torch.kernels.build import check, library
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

OP = "moe_gemm"


@functools.cache
def _entry():
    """The kernel entry with its C signature."""
    fn = library("moe_gemm").moe_gemm
    fn.restype = ctypes.c_int
    ll = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ll] * 3 + [
        ctypes.c_int, ll, ctypes.c_int, ctypes.c_void_p]
    return fn


def _weight_layout(w, k: int):
    """(base tensor, N, stride_e, stride_k, stride_n, n_half, half_stride)
    of a weight operand: one [E, K, N] tensor of any strides, or a pair of
    same-strided [E, K, N/2] views of one storage read as one panel."""
    if isinstance(w, (tuple, list)):
        a, b = w
        L.require(a.dim() == 3 and a.shape[1] == k, OP,
                  f"weight panel {tuple(a.shape)} is not [E, {k}, N/2]")
        L.require(a.shape == b.shape and a.stride() == b.stride(), OP,
                  "the two weight panels must share shape and strides")
        L.require(a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr(),
                  OP, "the two weight panels must be views of one tensor")
        half = (b.data_ptr() - a.data_ptr()) // a.element_size()
        L.require(half >= 0, OP, "the second panel must follow the first in memory")
        se, sk, sn = a.stride()
        n_half = a.shape[2]
        return a, 2 * n_half, se, sk, sn, n_half, half
    L.require(w.dim() == 3 and w.shape[1] == k, OP, f"w {tuple(w.shape)} is not [E, {k}, N]")
    se, sk, sn = w.stride()
    return w, w.shape[2], se, sk, sn, w.shape[2], 0


def _launch(x, w, tile_expert, bm: int) -> torch.Tensor:
    m, k = x.shape
    base, n, se, sk, sn, n_half, half = _weight_layout(w, k)
    L.same_device(OP, x, base, tile_expert)
    code = L.dtype_code(x, OP)
    L.require(base.dtype == x.dtype, OP, "x and w must share a dtype")
    L.require(x.is_contiguous(), OP, "x must be contiguous")
    L.require(bm % 64 == 0 and m % bm == 0, OP, f"rows {m} must tile by bm={bm} (64 | bm)")
    L.require(tile_expert.dtype == torch.int32 and tile_expert.shape == (m // bm,)
              and tile_expert.is_contiguous(), OP, "tile_expert must be int32 [M // bm]")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _entry()(L.ptr(x), L.ptr(base), L.ptr(tile_expert), L.ptr(out), m, k, n, bm,
             se, sk, sn, n_half, half, code, L.stream(x))
    check(err, OP)
    moe_gemm.launches += 1
    return out


def moe_gemm(x: torch.Tensor, w, tile_expert: torch.Tensor, *, bm: int = 128,
             backend: str = "auto") -> torch.Tensor:
    """x [M, K] sorted by expert, every expert group padded to bm rows;
    w [E, K, N] or a pair of [E, K, N/2] panels; tile_expert [M // bm]
    int32 -> [M, N] in x's dtype (fp32 sums)."""
    if use_kernel(backend, x, op=OP):
        with kernel_span(OP, "cuda"):
            return _launch(x, w, tile_expert, bm)
    with kernel_span(OP, "ref"):
        return moe_gemm_ref(x, w, tile_expert, bm)


moe_gemm.launches = 0
