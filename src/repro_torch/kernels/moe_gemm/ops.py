"""The fused grouped SwiGLU FFN over dispatched expert buffers (port of
repro/kernels/moe_gemm/ops.py:95-160, `grouped_expert_ffn`).

Lowered as two `moe_gemm` calls: gate and up as ONE wide GEMM (the two
[D, F] panels read side by side, without a copy when they are views of
one tier buffer), SiLU in fp32 then a cast back to h's dtype, times up,
then the down GEMM. Groups pad to the bm-row tile; the padding is exact
(silu(0) * 0 = 0 through the down product, and pad rows are sliced
off).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm.kernel import moe_gemm, pair_addressable


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _joinable(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when `b` is `a` shifted in one storage (a tier buffer's gate
    and up matrices) that the kernel can read as one panel in place
    (smoke-size bf16 experts, F = 32, cannot)."""
    return (
        a.stride() == b.stride()
        and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
        and b.data_ptr() >= a.data_ptr()
        and pair_addressable(a)
    )


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
    g, c, d = h.shape
    f = w_gate.shape[-1]
    if group_expert is None:
        assert g == w_gate.shape[0], (g, w_gate.shape)
        group_expert = torch.arange(g, dtype=torch.int32, device=h.device)
    c_pad = _round_up(c, bm)
    hp = F.pad(h, (0, 0, 0, c_pad - c)).reshape(g * c_pad, d)
    tile_expert = group_expert.to(torch.int32).repeat_interleave(c_pad // bm)
    # GEMM 1: x @ [w_gate | w_up], one [D, 2F] panel
    panels = (w_gate, w_up)
    if not _joinable(w_gate, w_up):
        panels = torch.cat([w_gate, w_up], dim=-1)
    gu = moe_gemm(hp, panels, tile_expert, bm=bm, backend=backend)
    a = F.silu(gu[:, :f].float()).to(h.dtype) * gu[:, f:]
    # GEMM 2: down projection
    o = moe_gemm(a.contiguous(), w_down, tile_expert, bm=bm, backend=backend)
    return o.reshape(g, c_pad, d)[:, :c]
