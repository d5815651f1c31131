"""Wrapper of the CUDA flash-attention kernel (csrc/flash_attention.cu),
the port of the Pallas TPU kernel `flash_attention`
(repro/kernels/flash_attention/flash_attention.py:66).

`flash_attention(..., backend=)` follows kernels/backend.py: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version `attention_ref`. `flash_attention.launches` counts kernel
launches. The route is chosen by dtype: bf16 runs the tensor-core
kernel (wgmma fed by TMA) at head widths `BF16_HEAD_DIMS`, fp32 the
CUDA-core kernel at any head width up to 128.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import use_kernel
from repro_torch.kernels.build import check, library
from repro_torch.kernels.flash_attention.ref import attention_ref

OP = "flash_attention"
BF16_HEAD_DIMS = (32, 64, 128)  # the bf16 kernel's instances


@functools.cache
def _entry():
    """(kernel entry, shared-memory size query, widest head)."""
    lib = library("flash_attention")
    smem = lib.flash_attention_smem
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    max_dh = lib.flash_attention_max_head_dim
    max_dh.restype = ctypes.c_int
    max_dh.argtypes = []
    fn = lib.flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn, smem, max_dh()


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    bh, sq, dh = q.shape
    sk = k.shape[1]
    L.same_device(OP, q, k, v)
    code = L.dtype_code(q, OP)
    L.require(k.dtype == q.dtype and v.dtype == q.dtype, OP, "q, k and v must share a dtype")
    L.require(k.shape == (bh, sk, dh) and v.shape == k.shape, OP,
              f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    for t in (q, k, v):
        L.require(t.is_contiguous(), OP, "all inputs must be contiguous")
    fn, smem_of, max_dh = _entry()
    if q.dtype == torch.bfloat16:
        L.require(dh in BF16_HEAD_DIMS, OP,
                  f"bf16 head width {dh} is none of the kernel's {BF16_HEAD_DIMS}")
        L.require(all(t.data_ptr() % L.TMA_ALIGN == 0 for t in (q, k, v)), OP,
                  f"bf16 q, k and v need {L.TMA_ALIGN}-byte aligned base addresses")
    L.require(dh <= max_dh, OP, f"head width {dh} above the kernel's {max_dh}")
    smem = smem_of(dh, code)
    L.require(smem <= L.MAX_SMEM, OP, f"head width {dh} needs {smem} B of shared memory")
    out = torch.empty_like(q)
    err = fn(L.ptr(q), L.ptr(k), L.ptr(v), L.ptr(out), bh, sq, sk, dh, int(causal),
             dh ** -0.5, code, L.device_index(q), L.stream(q))
    check(err, OP)
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, backend: str = "auto") -> torch.Tensor:
    """q: [BH, Sq, dh]; k, v: [BH, Sk, dh] -> [BH, Sq, dh] in q's dtype.
    Causal queries align to the end of the keys (query i sees key j iff
    j <= i + Sk - Sq)."""
    if use_kernel(backend, q, op=OP):
        return _launch(q, k, v, causal)
    return attention_ref(q[None], k[None], v[None], causal=causal)[0]


flash_attention.launches = 0
