"""Wrapper of the CUDA batched expert GEMV (csrc/expert_gemv.cu), the port
of the Pallas TPU kernel `expert_ffn_gemv`
(repro/kernels/expert_gemv/expert_gemv.py:44) as `cold_expert_ffn`
(expert_gemv/ops.py:23) runs it: all experts of a tier in one call.

bf16 runs the tensor-core design: a live-row prepass, then a gate|up and
a down pass on mma.sync fed by TMA that skip the slots whose token rows
are all zero (three launches per group of 32 tokens, one call;
`mma_plan` sizes their thread-block clusters). fp32 runs the CUDA-core
kernel, one launch per group of `f32_group` tokens plus the reduction.

`expert_ffn_gemv(..., backend=)` follows kernels/backend.py: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs
`expert_ffn_gemv_ref`. `expert_ffn_gemv.launches` counts wrapper calls
that launched the kernels. The kernel has no gradient, as the Pallas one
has none: on the card, tensors that autograd would record raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import use_kernel, wants_grad
from repro_torch.kernels.build import check, library
from repro_torch.kernels.expert_gemv.ref import expert_ffn_gemv_ref

OP = "expert_ffn_gemv"
MAX_BF = 64  # the fp32 kernel's widest F panel (one block per panel)
MMA_CHUNK = 64  # bf16 reduction depth (D or F) of one TMA stage
MMA_CLUSTERS = (1, 2, 4, 8)  # CTAs a panel's reduction axis may be split over
# a CTA keeps at least this many stages of the reduction (a cluster of
# shorter CTAs measured slower: PERF.md, PR 14)
MMA_MIN_STAGES = 16
ALIGN = 8  # bf16 elements in 16 bytes: the tensor-core passes' copy granule
MMA_GROUP = 32  # tokens a slot's passes take at once (more run group by group)


@functools.cache
def _entry():
    """(fp32 entry, bf16 entry, fp32 shared-memory query)."""
    lib = library("expert_gemv")
    smem = lib.expert_ffn_gemv_smem
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    f32 = lib.expert_ffn_gemv_f32
    f32.restype = i
    f32.argtypes = [vp] * 6 + [i] * 6 + [ll] * 9 + [vp]
    bf16 = lib.expert_ffn_gemv_bf16
    bf16.restype = i
    bf16.argtypes = [vp] * 7 + [i] * 6 + [ll] * 6 + [i, i, vp]
    return f32, bf16, smem


def panel_width(f: int) -> int:
    """F-panel width of one fp32 block: the widest of at most MAX_BF that
    the ops layer pads F to a multiple of."""
    return min(MAX_BF, f)


def f32_group(d: int) -> int:
    """Tokens of a slot the fp32 kernel stages at once: as many as fit a
    block's shared memory at width d (10 at d_model 5120). A longer slot
    runs group by group in the same call."""
    smem_of = _entry()[2]
    fixed = smem_of(0, d)
    g = (L.MAX_SMEM - fixed) // (smem_of(1, d) - fixed)
    L.require(g >= 1, OP, f"one fp32 token of width {d} does not fit shared memory")
    return g


def mma_plan(d: int, f: int) -> tuple:
    """(cs_gu, cs_dn): the cluster sizes of the gate|up pass (CTAs
    splitting D for one 64-wide F panel) and of the down pass (CTAs
    splitting F for one 64-wide D panel): the largest of MMA_CLUSTERS
    that leaves every CTA MMA_MIN_STAGES stages of its reduction."""
    def cluster(depth):
        stages = -(-depth // MMA_CHUNK)
        return max([cs for cs in MMA_CLUSTERS if stages >= cs * MMA_MIN_STAGES] or [1])
    return cluster(d), cluster(f)


def w2_layout(w2) -> tuple:
    """(fd, row stride) of W2 [E, F, D] as the down pass reads it: fd when
    it is stored [F, D] with unit stride along D (a model's parameter),
    else with unit stride along F (a tier buffer's transposed view); the
    row stride is the other axis's."""
    fd = w2.stride(1) != 1
    return fd, w2.stride(1) if fd else w2.stride(2)


def mma_addressable(x, w1, w3, w2) -> bool:
    """The bf16 passes copy 16-byte runs: W1 / W3 [E, D, F] need unit
    stride along F, W2 [E, F, D] along F or D, and every other stride and
    base a multiple of 16 bytes (D and F multiples of 8)."""
    d, f = x.shape[2], w1.shape[2]
    if d % ALIGN or f % ALIGN:
        return False
    fd, w2_row = w2_layout(w2)
    if w1.stride(2) != 1 or w3.stride(2) != 1 or w2.stride(2 if fd else 1) != 1:
        return False
    strides = (*w1.stride()[:2], *w3.stride()[:2], w2.stride(0), w2_row)
    ptrs = (x, w1, w3, w2)
    return (all(s % ALIGN == 0 for s in strides)
            and all(t.data_ptr() % (2 * ALIGN) == 0 for t in ptrs))


def _check(x, w1, w3, w2):
    e, t, d = x.shape
    f = w1.shape[2]
    L.same_device(OP, x, w1, w3, w2)
    L.require(w1.dtype == x.dtype and w3.dtype == x.dtype and w2.dtype == x.dtype, OP,
              "x and the weights must share a dtype")
    L.require(w1.shape == (e, d, f) and w3.shape == (e, d, f) and w2.shape == (e, f, d),
              OP, f"weights {tuple(w1.shape)}, {tuple(w3.shape)}, {tuple(w2.shape)} "
              f"do not match x {tuple(x.shape)}")
    L.require(x.is_contiguous(), OP, "x must be contiguous")


def _launch_f32(x, w1, w3, w2) -> torch.Tensor:
    e, t, d = x.shape
    f = w1.shape[2]
    bf = panel_width(f)
    L.require(f % bf == 0, OP, f"F={f} must be a multiple of the panel width {bf}")
    fn = _entry()[0]
    y = torch.empty_like(x)
    part = torch.empty((f // bf, e, t, d), dtype=torch.float32, device=x.device)
    err = fn(L.ptr(x), L.ptr(w1), L.ptr(w3), L.ptr(w2), L.ptr(part), L.ptr(y),
             e, t, d, f, bf, f32_group(d), *w1.stride(), *w3.stride(), *w2.stride(),
             L.stream(x))
    check(err, OP)
    return y


def _launch_bf16(x, w1, w3, w2) -> torch.Tensor:
    e, t, d = x.shape
    f = w1.shape[2]
    _, fn, _ = _entry()
    L.require(mma_addressable(x, w1, w3, w2), OP,
              "bf16 weights need unit stride along F (W2: F or D) and 16-byte aligned bases and "
              f"strides, D and F multiples of {ALIGN} (strides {w1.stride()}, "
              f"{w3.stride()}, {w2.stride()})")
    plan = mma_plan(d, f)
    fd, w2_row = w2_layout(w2)
    y = torch.empty_like(x)
    h = torch.empty((e, t, f), dtype=x.dtype, device=x.device)
    nlive = torch.empty((-(-t // MMA_GROUP), e), dtype=torch.int32, device=x.device)
    err = fn(L.ptr(x), L.ptr(w1), L.ptr(w3), L.ptr(w2), L.ptr(h), L.ptr(nlive), L.ptr(y),
             e, t, d, f, *plan, w1.stride(0), w1.stride(1), w3.stride(0), w3.stride(1),
             w2.stride(0), w2_row, int(fd), L.device_index(x), L.stream(x))
    check(err, OP)
    return y


def _launch(x, w1, w3, w2) -> torch.Tensor:
    if L.is_fake(x):
        e, t, d = x.shape
        return L.trace_launch(6 * e * t * d * w1.shape[-1], e, t, d, like=x)
    _check(x, w1, w3, w2)
    code = L.dtype_code(x, OP)
    y = _launch_f32(x, w1, w3, w2) if code == 0 else _launch_bf16(x, w1, w3, w2)
    expert_ffn_gemv.launches += 1
    return y


def expert_ffn_gemv(x, w1, w3, w2, *, backend: str = "auto") -> torch.Tensor:
    """x [E, T, D] few tokens per expert; w1/w3 [E, D, F]; w2 [E, F, D]
    (any strides in fp32; bf16 as `mma_addressable` says: a tier buffer's
    views and a model's row-major parameters are both read in place)
    -> [E, T, D] in x's dtype."""
    if use_kernel(backend, x, op=OP):
        if wants_grad(x, w1, w3, w2):
            raise RuntimeError(
                f"{OP}: the expert GEMV kernel has no gradient (nor has the reference's "
                "Pallas kernel); call it under torch.no_grad() or on detached tensors")
        return _launch(x, w1, w3, w2)
    return expert_ffn_gemv_ref(x, w1, w3, w2)


expert_ffn_gemv.launches = 0
