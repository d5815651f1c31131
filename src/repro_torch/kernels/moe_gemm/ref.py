"""Plain PyTorch versions of the grouped expert GEMM and of the fused
grouped SwiGLU FFN (ports of repro/kernels/moe_gemm/ref.py): the
kernel's tile -> expert contract (`moe_gemm_ref`), and the reference's
own group-size form (`moe_gemm_groups_ref`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import wants_grad


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
    te = tile_expert.long()
    # under autograd the gather runs in fp32, so the weight gradient sums
    # its tiles in fp32 and rounds once to w's dtype
    wt = w.float()[te] if wants_grad(w) else w[te].float()
    out = torch.bmm(x.reshape(m // bm, bm, k).float(), wt)
    return out.reshape(m, w.shape[-1]).to(x.dtype)


def moe_gemm_groups_ref(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor):
    """x [T, D] sorted by expert; w [E, D, F]; group_sizes [E] -> [T, F],
    row i = x[i] @ w[expert of row i] in x's dtype (the reference's
    `moe_gemm_ref` form: a row past the last group takes expert E - 1)."""
    t, e = x.shape[0], w.shape[0]
    ends = torch.cumsum(group_sizes, 0)
    rows = torch.arange(t, dtype=ends.dtype, device=x.device)
    expert_of = torch.searchsorted(ends, rows, right=True).clamp(0, e - 1)
    return torch.einsum("td,tdf->tf", x, w[expert_of])


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


GRAD_ROUNDINGS = 8  # bf16 roundings on the longest chain of the SwiGLU FFN's gradient


def grad_rounding_bound(want: torch.Tensor, roundings: int = GRAD_ROUNDINGS) -> torch.Tensor:
    """Elementwise bound on |kernel route - plain route| of a bf16
    `grouped_expert_ffn` output or gradient: `roundings` bf16 roundings
    (u = 2^-8 each) of the element itself or of the terms summed into it,
    which are of the size of its row's RMS. The two routes round the same
    values, but their fp32 sums in another order may round one ulp apart,
    and such a difference carries on: the longest chain is gate|up,
    SiLU * up (two roundings), the down product's dX, the SiLU
    backward (two), and the gate|up dX or a dW product."""
    w = want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    return roundings * torch.finfo(torch.bfloat16).eps / 2 * (w.abs() + rms)
