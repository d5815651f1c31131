"""Plain PyTorch version of the flash-attention kernel (port of
repro/kernels/flash_attention/ref.py).

Dense softmax attention. Scores and the PV product sum in fp32, with P
rounded to the value dtype first, as the kernel does; in fp32 this is
the JAX oracle's arithmetic. Causal queries align to the END of the
keys: query i sees key j iff j <= i + (sk - sq).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True):
    """q: [B, H, Sq, dh]; k/v: [B, H, Sk, dh] -> [B, H, Sq, dh] in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        kpos = torch.arange(sk, device=q.device)
        qpos = torch.arange(sq, device=q.device) + (sk - sq)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def rounding_bound(q, k, v, causal: bool = True):
    """Elementwise bound on |kernel - attention_ref| when v is in a 16-bit
    dtype, in attention_ref's layout, from the two roundings that differ:
    each side rounds every p to v's dtype (the kernel p = exp(s - running
    max), the plain version the normalized softmax), at most eps/2 off
    relative, so the PV sums differ by at most eps * sum(p |v|); and each
    rounds its output, at most one ulp <= eps * |o| apart. In fp32 both
    terms vanish and the summation order sets the error instead."""
    eps = torch.finfo(v.dtype).eps
    o = attention_ref(q, k, v, causal).float().abs()
    return eps * (o + attention_ref(q, k, v.abs(), causal).float())
