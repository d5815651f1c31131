"""Wrapper of the CUDA grouped expert GEMM (csrc/moe_gemm.cu), the port
of the Pallas TPU kernel `moe_gemm` (repro/kernels/moe_gemm/moe_gemm.py:34).

`moe_gemm(..., backend=)` follows kernels/backend.py: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs `moe_gemm_ref`.
`moe_gemm.launches` counts kernel launches. The route is chosen by
dtype: bf16 runs the tensor-core kernel (wgmma fed by TMA), which reads
the weight through a 4-D tensor map that `tma_weight_map` derives from
its strides; fp32 runs the CUDA-core kernel (TF32 would break the fp32
tolerance). Where the bf16 kernel cannot address an operand, the
wrapper raises ValueError; it never reroutes.

The kernel route is differentiable (`_MoEGemm`; the Pallas kernel has no
gradient, so the reference trains only through its einsums). dX is the
kernel's own product, dY times each tile's expert matrix transposed: the
same kernel on a K-major view of the weight, no copy. dW = x_gᵀ dY_g per
group is the product XLA computes for the einsums' gradient outside any
Pallas kernel, so it stays `torch.bmm`, summed into expert rows in fp32.
A pair of panels is joined into one [E, K, N] tensor first when a
gradient is wanted (its transpose would pair along K, which the kernel
does not read).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import kernel_span, use_kernel, wants_grad
from repro_torch.kernels.build import check, library
from repro_torch.kernels.moe_gemm.ref import join_panels, moe_gemm_ref

OP = "moe_gemm"
BOX = 64  # edge of the bf16 kernel's TMA boxes: one 128-byte swizzled row


@functools.cache
def _entries():
    """(fp32 entry, bf16 entry) with their C signatures."""
    lib = library("moe_gemm")
    ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    f32 = lib.moe_gemm_f32
    f32.restype = i32
    f32.argtypes = [ptr] * 4 + [i32] * 4 + [ll] * 3 + [i32, ll, ptr]
    bf16 = lib.moe_gemm_bf16
    bf16.restype = i32
    bf16.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.POINTER(ctypes.c_ulonglong)] * 2 + [
        i32, i32, ptr]
    return f32, bf16


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def weight_layout(w, k: int):
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


def tma_weight_map(layout):
    """The bf16 kernel's view of a weight operand, given its
    `weight_layout`, as one 4-D TMA tensor map: (k_major, dims innermost
    first, byte strides of dims 1..3). stride_n == 1 (gate|up, [D, F]
    row-major) is MN-major, dims (n_half, K, halves, E); stride_k == 1
    (the down GEMM's transposed view) is K-major, dims (K, n_half,
    halves, E). A pair of panels is halves = 2, the second at
    `half_stride`. Raises ValueError where TMA cannot address the
    operand: no unit stride along K or N, a byte stride or base address
    that is not a multiple of 16, or a pair whose half is not a multiple
    of the 64-column box."""
    base, n, se, sk, sn, n_half, half = layout
    e, k = base.shape[:2]
    halves = 2 if n_half < n else 1
    half_stride = half if halves == 2 else se  # a single panel: any valid stride
    if sn == 1:
        k_major, dims, strides = False, (n_half, k, halves, e), (sk, half_stride, se)
    elif sk == 1:
        k_major, dims, strides = True, (k, n_half, halves, e), (sn, half_stride, se)
    else:
        raise ValueError(f"{OP}: bf16 weight strides {(se, sk, sn)} have no unit stride "
                         f"along K or N")
    strides = tuple(s * base.element_size() for s in strides)
    L.require(all(s % L.TMA_ALIGN == 0 for s in strides), OP,
              f"bf16 weight byte strides {strides} are not multiples of {L.TMA_ALIGN}")
    L.require(base.data_ptr() % L.TMA_ALIGN == 0, OP,
              f"bf16 weight base address is not {L.TMA_ALIGN}-byte aligned")
    L.require(halves == 1 or pair_addressable(base), OP,
              f"a pair panel's half {n_half} is not a multiple of {BOX} columns")
    return k_major, dims, strides


def pair_addressable(a: torch.Tensor) -> bool:
    """True when a [E, K, N/2] panel can be one half of a pair the kernel
    reads in place: fp32 always; bf16 picks a half per BOX-column box, so
    there the half must be a whole number of boxes."""
    return a.dtype != torch.bfloat16 or a.shape[-1] % BOX == 0


def pick_bn(m_blocks: int, n: int, n_sm: int) -> int:
    """The bf16 kernel's block width: 128 unless that leaves fewer blocks
    than the card has SMs (then 64, twice the blocks)."""
    return 128 if m_blocks * -(-n // 128) >= n_sm else 64


def _launch_bf16(x, layout, tile_expert, bm: int, out) -> int:
    m, k = x.shape
    base, n, n_half = layout[0], layout[1], layout[5]
    k_major, dims, strides = tma_weight_map(layout)
    L.require(k * x.element_size() % L.TMA_ALIGN == 0 and x.data_ptr() % L.TMA_ALIGN == 0, OP,
              f"bf16 x needs a {L.TMA_ALIGN}-byte aligned base and row stride (K = {k})")
    block_m = 128 if bm % 128 == 0 else 64
    bn = pick_bn(m // block_m, n, _n_sm(L.device_index(x)))
    c_dims = (ctypes.c_ulonglong * 4)(*dims)
    c_strides = (ctypes.c_ulonglong * 3)(*strides)
    return _entries()[1](L.ptr(x), L.ptr(base), L.ptr(tile_expert), L.ptr(out), m, k, n, bm,
                         bn, int(k_major), c_dims, c_strides, n_half, L.device_index(x),
                         L.stream(x))


def _launch(x, w, tile_expert, bm: int) -> torch.Tensor:
    m, k = x.shape
    layout = weight_layout(w, k)
    base, n = layout[:2]
    L.same_device(OP, x, base, tile_expert)
    L.dtype_code(x, OP)
    L.require(base.dtype == x.dtype, OP, "x and w must share a dtype")
    L.require(x.is_contiguous(), OP, "x must be contiguous")
    L.require(bm % 64 == 0 and m % bm == 0, OP, f"rows {m} must tile by bm={bm} (64 | bm)")
    L.require(tile_expert.dtype == torch.int32 and tile_expert.shape == (m // bm,)
              and tile_expert.is_contiguous(), OP, "tile_expert must be int32 [M // bm]")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        err = _launch_bf16(x, layout, tile_expert, bm, out)
    else:
        err = _entries()[0](L.ptr(x), L.ptr(base), L.ptr(tile_expert), L.ptr(out), m, k, n,
                            bm, *layout[2:], L.stream(x))
    check(err, OP)
    moe_gemm.launches += 1
    return out


class _MoEGemm(torch.autograd.Function):
    """The kernel launch under autograd: forward and dX on the kernel,
    dW by `torch.bmm` per group of `rows` rows (a multiple of bm), summed
    into expert `group_expert[g]` (group g's own expert when None)."""

    @staticmethod
    def forward(ctx, x, w, tile_expert, bm, rows, group_expert):
        ctx.save_for_backward(x, w, tile_expert, group_expert)
        ctx.bm, ctx.rows = bm, rows
        return _launch(x, w, tile_expert, bm)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert, group_expert = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _launch(dy, w.transpose(1, 2), tile_expert, ctx.bm)
        if ctx.needs_input_grad[1]:
            (m, k), n = x.shape, dy.shape[1]
            g = m // ctx.rows
            per_group = torch.bmm(x.view(g, ctx.rows, k).transpose(1, 2),
                                  dy.view(g, ctx.rows, n))
            if group_expert is None:
                dw = per_group
            else:
                dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                dw = dw.index_add_(0, group_expert.long(), per_group.float()).to(w.dtype)
        return dx, dw, None, None, None, None


def moe_gemm(x: torch.Tensor, w, tile_expert: torch.Tensor, *, bm: int = 128,
             backend: str = "auto", groups=None) -> torch.Tensor:
    """x [M, K] sorted by expert, every expert group padded to bm rows;
    w [E, K, N] or a pair of [E, K, N/2] panels; tile_expert [M // bm]
    int32 -> [M, N] in x's dtype (fp32 sums). `groups` = (rows,
    group_expert) tells the weight gradient that x is M // rows groups
    of `rows` rows, group g of expert group_expert[g] (None: expert g);
    by default every bm-row tile is a group of expert tile_expert[m]."""
    if use_kernel(backend, x, op=OP):
        with kernel_span(OP, "cuda"):
            panels = w if isinstance(w, (tuple, list)) else (w,)
            if not wants_grad(x, *panels):
                return _launch(x, w, tile_expert, bm)
            rows, group_expert = groups or (bm, tile_expert)
            return _MoEGemm.apply(x, join_panels(w), tile_expert, bm, rows, group_expert)
    with kernel_span(OP, "ref"):
        return moe_gemm_ref(x, w, tile_expert, bm)


moe_gemm.launches = 0
