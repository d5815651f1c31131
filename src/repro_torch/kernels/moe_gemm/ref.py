"""Plain PyTorch versions of the grouped expert GEMM and of the fused
grouped SwiGLU FFN (ports of repro/kernels/moe_gemm/ref.py, with the
kernel's tile -> expert contract)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def join_panels(w) -> torch.Tensor:
    """A weight operand as one [E, K, N] tensor: a pair (w_a, w_b) of
    [E, K, N/2] views is the two panels side by side along N."""
    if isinstance(w, (tuple, list)):
        return torch.cat(list(w), dim=-1)
    return w


def moe_gemm_ref(x: torch.Tensor, w, tile_expert: torch.Tensor, bm: int = 128):
    """x [M, K] with M a multiple of bm; w [E, K, N] (or a pair of panels);
    tile_expert [M // bm] -> [M, N]: row tile m times expert
    tile_expert[m]'s weights, fp32 sums, cast to x's dtype."""
    w = join_panels(w)
    m, k = x.shape
    wt = w[tile_expert.long()].float()  # [M // bm, K, N]
    out = torch.bmm(x.reshape(m // bm, bm, k).float(), wt)
    return out.reshape(m, w.shape[-1]).to(x.dtype)


def grouped_ffn_ref(h, w_gate, w_up, w_down, group_expert=None):
    """Grouped SwiGLU expert FFN: group g of h [G, C, D] runs the FFN of
    expert group_expert[g] (identity when None). SiLU in fp32, cast back
    to h's dtype, times up, then down; products in h's dtype."""
    if group_expert is not None:
        idx = group_expert.long()
        w_gate, w_up, w_down = w_gate[idx], w_up[idx], w_down[idx]
    g = torch.einsum("ecd,edf->ecf", h, w_gate)
    u = torch.einsum("ecd,edf->ecf", h, w_up)
    a = F.silu(g.float()).to(h.dtype) * u
    return torch.einsum("ecf,efd->ecd", a, w_down)
