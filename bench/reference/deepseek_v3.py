"""The plain reference's DeepSeek-V3 layer, in float32, written from the
published model's description (its config.json and modeling code, read,
not imported). Imports neither JAX nor anything of the program; the
shared pieces come from `layers.py`.

The equations, per layer (pre-norm residual blocks, as `layers.block`):

- YaRN RoPE on the 64 rope dims: frequency i (of half = rd / 2) is
  theta^(-i / half), divided by `factor` above a linear ramp between the
  dims that turn `beta_fast` and `beta_slow` times over the original
  context (extrapolated below it); cos and sin times mscale(factor,
  mscale) / mscale(factor, mscale_all_dim), mscale(f, m) = 0.1 m ln f + 1.
  Halves rotate as in `layers.rope`.
- MLA, expanded: q = rmsnorm(x Wq_a) Wq_b split into (nope, rope);
  [c_kv, k_rope] = x Wkv_a, c_kv through RMSNorm; [k_nope, v] = c_kv Wkv_b
  per head; k_rope shared by the heads; scores scaled by (nope + rope)^-0.5
  times mscale(factor, mscale_all_dim)^2; causal softmax; Wo over (head, v).
- Routed experts (`noaux_tc`): s = sigmoid(x W_router) over every routed
  expert; group g's score is the sum of its two highest s + bias; the
  `topk_group` best groups stay, and the top-k of s + bias among their
  experts are chosen; weight = s / (sum of the k chosen s) * scale. Only
  the experts held here (`held_from` .. + `n_experts`) add their weighted
  outputs; the shared experts add unweighted.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from reference.layers import Quant, _causal_attention, mm, rmsnorm, swiglu


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_rope(x: torch.Tensor, pos: torch.Tensor, theta: float, yarn: tuple) -> torch.Tensor:
    """x [S, heads, dim] at positions pos [S], YaRN-scaled as `yarn` =
    (factor, original context, beta_fast, beta_slow, mscale,
    mscale_all_dim) gives it."""
    factor, n_ctx, beta_fast, beta_slow, m, m_all = yarn
    dim = x.shape[-1]
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=x.device)
    extra = 1.0 / theta ** (i / half)

    def at(rotations):  # the dim turning `rotations` times over n_ctx
        return dim * math.log(n_ctx / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(at(beta_fast)), 0)
    high = min(math.ceil(at(beta_slow)), dim - 1)
    ramp = torch.clamp((i - low) / (high - low if high != low else 0.001), 0, 1)
    freqs = extra / factor * ramp + extra * (1 - ramp)
    ang = pos.float()[:, None] * freqs
    k = mscale(factor, m) / mscale(factor, m_all)
    cos, sin = (torch.cos(ang) * k)[:, None, :], (torch.sin(ang) * k)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla(w: Dict[str, torch.Tensor], x: torch.Tensor, dims, quant: Quant) -> torch.Tensor:
    s, d = x.shape
    h, nope, rd = dims.n_heads, dims.qk_nope_head_dim, dims.qk_rope_head_dim
    r, dv, ql, eps = dims.kv_lora_rank, dims.v_head_dim, dims.q_lora_rank, dims.norm_eps
    pos = torch.arange(s, device=x.device)
    qa = rmsnorm(mm(x, w["mixer.wq_a"], quant), w["mixer.q_norm.scale"], eps)
    q = mm(qa, w["mixer.wq_b"].reshape(ql, -1), quant).reshape(s, h, nope + rd)
    q = torch.cat([q[..., :nope], yarn_rope(q[..., nope:], pos, dims.rope_theta, dims.yarn)],
                  dim=-1)
    kv_a = mm(x, w["mixer.wkv_a"], quant)
    ckv = rmsnorm(kv_a[:, :r], w["mixer.kv_norm.scale"], eps)
    krope = yarn_rope(kv_a[:, None, r:], pos, dims.rope_theta, dims.yarn)
    kvb = mm(ckv, w["mixer.wkv_b"].reshape(r, -1), quant).reshape(s, h, nope + dv)
    k = torch.cat([kvb[..., :nope], krope.expand(s, h, rd)], dim=-1)
    scale = (nope + rd) ** -0.5 * mscale(dims.yarn[0], dims.yarn[5]) ** 2
    o = _causal_attention(q, k, kvb[..., nope:], scale)
    return mm(o.reshape(s, h * dv), w["mixer.wo"].reshape(h * dv, d), quant)


def routing(logits: torch.Tensor, bias: torch.Tensor, dims) -> tuple:
    """(weights [S, k], expert ids [S, k]) of router logits [S, routed]
    under `noaux_tc`."""
    scores = torch.sigmoid(logits)
    choice = scores + bias
    n, r = choice.shape
    per = r // dims.n_group
    group_score = choice.reshape(n, dims.n_group, per).topk(2, dim=-1).values.sum(-1)
    best = group_score.topk(dims.topk_group, dim=-1).indices
    allowed = torch.zeros(n, dims.n_group, dtype=torch.bool, device=logits.device)
    allowed[torch.arange(n, device=logits.device)[:, None], best] = True
    allowed = allowed[:, :, None].expand(n, dims.n_group, per).reshape(n, r)
    ids = torch.where(allowed, choice, torch.full_like(choice, float("-inf"))).topk(
        dims.top_k, dim=-1).indices
    weights = scores.gather(1, ids)
    return weights / weights.sum(-1, keepdim=True) * dims.routed_scale, ids


def moe(w: Dict[str, torch.Tensor], x: torch.Tensor, dims, quant: Quant) -> torch.Tensor:
    top_w, top_i = routing(mm(x, w["ffn.router"], quant), w["ffn.router_bias"], dims)
    y = torch.zeros_like(x)
    for e in torch.unique(top_i).tolist():
        local = e - dims.held_from
        if not 0 <= local < dims.n_experts:
            continue  # held on another chip
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        out = swiglu(x[rows], w["ffn.w_gate"][local], w["ffn.w_up"][local],
                     w["ffn.w_down"][local], quant)
        y.index_add_(0, rows, out * top_w[rows, slot][:, None])
    for j in range(dims.n_shared):
        y = y + swiglu(x, w["ffn.shared.w_gate"][j], w["ffn.shared.w_up"][j],
                       w["ffn.shared.w_down"][j], quant)
    return y


def block(w: Dict[str, torch.Tensor], x: torch.Tensor, dims, i: int,
          quant: Quant) -> torch.Tensor:
    """Layer `i`: MLA, then the dense FFN or the routed experts."""
    x = x + mla(w, rmsnorm(x, w["norm1.scale"], dims.norm_eps), dims, quant)
    h = rmsnorm(x, w["norm2.scale"], dims.norm_eps)
    if dims.sigs[i][1] == "dense":
        return x + swiglu(h, w["ffn.w_gate"], w["ffn.w_up"], w["ffn.w_down"], quant)
    return x + moe(w, h, dims, quant)
