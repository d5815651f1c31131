"""Plain PyTorch version of the fused few-token expert FFN (the
arithmetic of the Pallas kernel repro/kernels/expert_gemv/expert_gemv.py:
fp32 sums, h cast to x's dtype before the W2 product)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def expert_ffn_gemv_ref(x, w1, w3, w2):
    """x [E, T, D]; w1/w3 [E, D, F]; w2 [E, F, D] -> [E, T, D]:
    y = (silu(x W1) * (x W3)).astype(x) @ W2, every product summed in
    fp32, cast to x's dtype."""
    xf = x.float()
    g = torch.bmm(xf, w1.float())
    u = torch.bmm(xf, w3.float())
    h = (F.silu(g) * u).to(x.dtype)
    return torch.bmm(h.float(), w2.float()).to(x.dtype)
