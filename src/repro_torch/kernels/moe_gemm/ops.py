"""Wrappers of the grouped expert GEMM (port of
repro/kernels/moe_gemm/ops.py).

`grouped_expert_matmul` (ops.py:38) does the host-side prep the raw
kernel contract requires: a stable sort of the tokens by expert, every
expert group padded to the bm-row tile, the tile -> expert map, and the
unsort of the result. backend="ref" is the reference's plain route, the
group-size form `moe_gemm_groups_ref`; otherwise the padded route runs
`moe_gemm` (the kernel on a CUDA tensor, its plain version on a CPU one).

`grouped_expert_ffn` (ops.py:95-160) is the fused SwiGLU FFN over
dispatched expert buffers, lowered as two `moe_gemm` calls: gate and up
as ONE wide GEMM (the two [D, F] panels read side by side, without a
copy when they are views of one tier buffer), SiLU in fp32 then a cast
back to h's dtype, times up, then the down GEMM. Groups pad to the
bm-row tile; the padding is exact (silu(0) * 0 = 0 through the down
product, and pad rows are sliced off). Under autograd the SiLU * up
part, the padding and the slicing are plain PyTorch and the two GEMMs
are `moe_gemm`'s differentiable kernel route.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import kernel_span, resolve_backend
from repro_torch.kernels.moe_gemm.kernel import moe_gemm, pair_addressable
from repro_torch.kernels.moe_gemm.ref import moe_gemm_groups_ref


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _joinable(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when `b` is `a` shifted in one storage (a tier buffer's gate
    and up matrices) that the kernel can read as one panel in place
    (smoke-size bf16 experts, F = 32, cannot)."""
    from torch.multiprocessing.reductions import StorageWeakRef

    # storage identity and offsets, not data pointers: a fake tensor has none
    return (
        a.stride() == b.stride()
        and StorageWeakRef(a.untyped_storage()) == StorageWeakRef(b.untyped_storage())
        and b.storage_offset() >= a.storage_offset()
        and pair_addressable(a)
    )


def grouped_expert_matmul(
    x: torch.Tensor,  # [T, D] tokens in any order
    expert_of: torch.Tensor,  # [T] int expert id per token
    w: torch.Tensor,  # [E, D, F]
    *,
    capacity: int,  # upper bound of the padded row count
    bm: int = 128,
    backend: str = "auto",
) -> torch.Tensor:
    """[T, F], row i = x[i] @ w[expert_of[i]]. Rows padded past
    round_up(capacity, bm) are dropped (and read back clamped), as the
    reference's are."""
    t, d = x.shape
    e = w.shape[0]
    order = torch.argsort(expert_of, stable=True)
    xs, se = x[order], expert_of[order].long()
    group_sizes = torch.bincount(se, minlength=e)
    with kernel_span("grouped_expert_matmul", backend, x):
        if resolve_backend(backend) == "ref":
            ys = moe_gemm_groups_ref(xs, w, group_sizes)
        else:
            padded = (group_sizes + bm - 1) // bm * bm
            ends = torch.cumsum(padded, 0)
            starts = ends - padded
            rank = torch.arange(t, device=x.device) - torch.searchsorted(se, se)
            dest = starts[se] + rank
            t_pad = _round_up(capacity, bm)
            keep = dest < t_pad
            xp = x.new_zeros(t_pad, d).index_put((dest[keep],), xs[keep])
            tile_start = torch.arange(0, t_pad, bm, device=x.device)
            tile_expert = torch.searchsorted(ends, tile_start, right=True).clamp(0, e - 1)
            yp = moe_gemm(xp, w, tile_expert.to(torch.int32), bm=bm, backend=backend)
            ys = yp[dest.clamp(max=t_pad - 1)]
    return ys[torch.argsort(order)]


def grouped_expert_ffn(
    h: torch.Tensor,  # [G, C, D] per-group dispatch buffers
    w_gate: torch.Tensor,  # [E, D, F]
    w_up: torch.Tensor,  # [E, D, F]
    w_down: torch.Tensor,  # [E, F, D]
    group_expert: Optional[torch.Tensor] = None,  # [G] weight row per group
    *,
    bm: int = 128,
    backend: str = "auto",
) -> torch.Tensor:
    """[G, C, D] -> [G, C, D], group g using expert group_expert[g]'s
    weights (identity when None)."""
    with kernel_span("grouped_expert_ffn", backend, h):
        g, c, d = h.shape
        f = w_gate.shape[-1]
        c_pad = _round_up(c, bm)
        groups = (c_pad, group_expert)  # the weight gradient's groups
        if group_expert is None:
            assert g == w_gate.shape[0], (g, w_gate.shape)
            group_expert = torch.arange(g, dtype=torch.int32, device=h.device)
        hp = F.pad(h, (0, 0, 0, c_pad - c)).reshape(g * c_pad, d)
        tile_expert = group_expert.to(torch.int32).repeat_interleave(c_pad // bm)
        # GEMM 1: x @ [w_gate | w_up], one [D, 2F] panel
        panels = (w_gate, w_up)
        if not _joinable(w_gate, w_up):
            panels = torch.cat([w_gate, w_up], dim=-1)
        gu = moe_gemm(hp, panels, tile_expert, bm=bm, backend=backend, groups=groups)
        a = F.silu(gu[:, :f].float()).to(h.dtype) * gu[:, f:]
        # GEMM 2: down projection
        o = moe_gemm(a.contiguous(), w_down, tile_expert, bm=bm, backend=backend,
                     groups=groups)
        return o.reshape(g, c_pad, d)[:, :c]
