"""Wrapper of the CUDA batched expert GEMV (csrc/expert_gemv.cu), the port
of the Pallas TPU kernel `expert_ffn_gemv`
(repro/kernels/expert_gemv/expert_gemv.py:44) as `cold_expert_ffn`
(expert_gemv/ops.py:23) runs it: all experts of a tier in ONE launch.

`expert_ffn_gemv(..., backend=)` follows kernels/backend.py: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs
`expert_ffn_gemv_ref`. `expert_ffn_gemv.launches` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import kernel_span, use_kernel
from repro_torch.kernels.build import check, library
from repro_torch.kernels.expert_gemv.ref import expert_ffn_gemv_ref

OP = "expert_ffn_gemv"
MAX_BF = 64  # the kernel's widest F panel (one block per panel)


@functools.cache
def _entry():
    """(kernel entry, shared-memory size query) with their C signatures."""
    lib = library("expert_gemv")
    smem = lib.expert_ffn_gemv_smem
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    fn = lib.expert_ffn_gemv
    fn.restype = ctypes.c_int
    ll = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ll] * 9 + [
        ctypes.c_int, ctypes.c_void_p]
    return fn, smem


def panel_width(f: int) -> int:
    """F-panel width of one block: the widest of at most MAX_BF that the
    ops layer pads F to a multiple of."""
    return min(MAX_BF, f)


def _launch(x, w1, w3, w2) -> torch.Tensor:
    e, t, d = x.shape
    f = w1.shape[2]
    bf = panel_width(f)
    L.same_device(OP, x, w1, w3, w2)
    code = L.dtype_code(x, OP)
    L.require(w1.dtype == x.dtype and w3.dtype == x.dtype and w2.dtype == x.dtype, OP,
              "x and the weights must share a dtype")
    L.require(w1.shape == (e, d, f) and w3.shape == (e, d, f) and w2.shape == (e, f, d),
              OP, f"weights {tuple(w1.shape)}, {tuple(w3.shape)}, {tuple(w2.shape)} "
              f"do not match x {tuple(x.shape)}")
    L.require(f % bf == 0, OP, f"F={f} must be a multiple of the panel width {bf}")
    L.require(x.is_contiguous(), OP, "x must be contiguous")
    fn, smem_of = _entry()
    smem = smem_of(t, d)
    L.require(smem <= L.MAX_SMEM, OP, f"{t} tokens of width {d} need {smem} B of "
              f"shared memory")
    y = torch.empty_like(x)
    part = torch.empty((f // bf, e, t, d), dtype=torch.float32, device=x.device)
    err = fn(L.ptr(x), L.ptr(w1), L.ptr(w3), L.ptr(w2), L.ptr(part), L.ptr(y),
             e, t, d, f, bf, *w1.stride(), *w3.stride(), *w2.stride(), code,
             L.stream(x))
    check(err, OP)
    expert_ffn_gemv.launches += 1
    return y


def expert_ffn_gemv(x, w1, w3, w2, *, backend: str = "auto") -> torch.Tensor:
    """x [E, T, D] few tokens per expert; w1/w3 [E, D, F]; w2 [E, F, D]
    (any strides) -> [E, T, D] in x's dtype."""
    if use_kernel(backend, x, op=OP):
        with kernel_span(OP, "cuda"):
            return _launch(x, w1, w3, w2)
    with kernel_span(OP, "ref"):
        return expert_ffn_gemv_ref(x, w1, w3, w2)


expert_ffn_gemv.launches = 0
