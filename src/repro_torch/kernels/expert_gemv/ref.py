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


def _neighbours(h):
    """The magnitudes next below and next above |h| in h's 16-bit dtype,
    as fp32."""
    bits = h.abs().view(torch.int16)
    return ((bits - 1).clamp_min(0).view(h.dtype).float(),
            (bits + 1).view(h.dtype).float())


def gemv_rounding_bound(x, w1, w3, w2, lam: float = 4.0):
    """Elementwise bound on |kernel - expert_ffn_gemv_ref| when x is in a
    16-bit dtype. Both sides round the same h = silu(g) * u of fp32 sums
    and sum h W2 in fp32; they differ only where their roundings can:
    - the same n products summed in fp32 in another order: each side's
      error is a sum of n roundings of the partial sums, of size about
      eps32 * sqrt(n) * ||products||_2 for products of random sign
      (probabilistic rounding error analysis); `lam` times that on each
      side bounds the g, u and y sums;
    - so an h whose fp32 value lies that close to a rounding midpoint may
      round one step apart, moving y by the step times |W2|; every other
      h rounds the same on both sides;
    - each side rounds y, at most one ulp <= eps * |y| apart.
    Tight enough that an h left unrounded breaks it where h's rounding
    errors line up with W2's signs."""
    eps, eps32 = torch.finfo(x.dtype).eps, torch.finfo(torch.float32).eps
    d, f = x.shape[-1], w1.shape[-1]
    xf, a1, a3, a2 = x.float(), w1.float(), w3.float(), w2.float()

    def sum_err(a, b, n):  # how far the two sides' fp32 sums a @ b may be apart
        return 2 * lam * eps32 * n ** 0.5 * torch.bmm(a * a, b * b).sqrt()

    g, u = torch.bmm(xf, a1), torch.bmm(xf, a3)
    sig = torch.sigmoid(g)
    hf = g * sig * u
    # silu and the product add a few roundings on each side
    dh = ((sig * (1 + g * (1 - sig))).abs() * u.abs() * sum_err(xf, a1, d)
          + (g * sig).abs() * sum_err(xf, a3, d) + 16 * eps32 * hf.abs())
    h = hf.to(x.dtype)
    mag, (dn, up) = h.float().abs(), _neighbours(h)
    hi_mid = (mag + up) / 2
    lo_mid = torch.where(mag == 0, -hi_mid, (mag + dn) / 2)
    near = torch.minimum(hi_mid - hf.abs(), hf.abs() - lo_mid) <= dh
    flips = torch.where(near, up - mag, torch.zeros_like(mag))
    y = expert_ffn_gemv_ref(x, w1, w3, w2).float().abs()
    return eps * y + (1 + eps) * (sum_err(mag, a2, f) + torch.bmm(flips, a2.abs()))
