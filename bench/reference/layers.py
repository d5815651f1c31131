"""The plain reference's layers, in float32, written from the JAX package's
model definitions (read, not imported), with no kernel, cache or
batching. Imports neither JAX nor anything of the program. A model
family (`bench/families/<model_type>.py`) composes them, or brings a
`reference_layer` of its own.

The equations, per layer (pre-norm residual blocks):

    x = x + mixer(rmsnorm(x) * s1);  x = x + ffn(rmsnorm(x) * s2)

- RoPE rotates the two halves of a head vector ([x1, x2] ->
  [x1 cos - x2 sin, x1 sin + x2 cos]) by position * theta^(-i / half).
- MLA (expanded): q = x Wq split into (nope, rope); [c_kv, k_rope] = x Wkv_a;
  [k_nope, v] = c_kv Wkv_b per head; k_rope is shared by the heads; scores
  q.k scaled by (nope + rope)^-0.5, causal softmax, then Wo over (head, v).
- GQA: query head h reads key/value head h // (H / Kv); scale hd^-0.5.
- Mamba: [x, z] = x W_in; causal depthwise conv (kernel d_conv, bias),
  SiLU; [dt_in, B, C] = x W_x; dt = softplus(dt_in W_dt + b_dt);
  h_t = exp(dt A) h_{t-1} + dt x B with A = -exp(A_log); y = h.C + D x;
  out = (y * SiLU(z)) W_out.
- Dense FFN and every expert: (SiLU(x Wg) * x Wu) Wd.
- Routed experts: p = softmax(x W_router); the top-k p, renormalized to
  sum 1 where `norm_topk_prob`, weight their experts; shared experts add
  unweighted.

`quant` is the control's lower precision: a function applied to both
operands of every matrix product (`fp8_operands` below); None is float32.
Attention scores, the scan, norms and softmax stay float32 either way.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from spec import Dims

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]


def strict_fp32() -> None:
    """No TF32 in float32 products (the reference's stated precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_operands(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Round `t` to float8 e4m3 with one scale per slice along `dim`
    (the contracted dimension: per row of an activation, per output
    column of a weight), and back to float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    """x [..., K] @ w [K, N] in float32 (operands through `quant`)."""
    if quant is not None:
        x, w = quant(x, -1), quant(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, dim] at positions pos [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """q [S, H, dk], k [S, H, dk], v [S, H, dv] -> [S, H, dv]."""
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    n = q.shape[0]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def mla(w: Dict[str, torch.Tensor], x: torch.Tensor, dims: Dims, quant: Quant) -> torch.Tensor:
    s, d = x.shape
    h, nope, rd = dims.n_heads, dims.qk_nope_head_dim, dims.qk_rope_head_dim
    r, dv = dims.kv_lora_rank, dims.v_head_dim
    pos = torch.arange(s, device=x.device)
    q = mm(x, w["mixer.wq"].reshape(d, -1), quant).reshape(s, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, dims.rope_theta)], dim=-1)
    kv_a = mm(x, w["mixer.wkv_a"], quant)
    ckv, krope = kv_a[:, :r], rope(kv_a[:, None, r:], pos, dims.rope_theta)
    kvb = mm(ckv, w["mixer.wkv_b"].reshape(r, -1), quant).reshape(s, h, nope + dv)
    k = torch.cat([kvb[..., :nope], krope.expand(s, h, rd)], dim=-1)
    o = _causal_attention(q, k, kvb[..., nope:], (nope + rd) ** -0.5)
    return mm(o.reshape(s, h * dv), w["mixer.wo"].reshape(h * dv, d), quant)


def gqa(w: Dict[str, torch.Tensor], x: torch.Tensor, dims: Dims, quant: Quant) -> torch.Tensor:
    s, d = x.shape
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    pos = torch.arange(s, device=x.device)
    q = rope(mm(x, w["mixer.wq"].reshape(d, -1), quant).reshape(s, h, hd), pos,
             dims.rope_theta)
    k = rope(mm(x, w["mixer.wk"].reshape(d, -1), quant).reshape(s, kv, hd), pos,
             dims.rope_theta)
    v = mm(x, w["mixer.wv"].reshape(d, -1), quant).reshape(s, kv, hd)
    g = h // kv
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    o = _causal_attention(q, k, v, hd ** -0.5)
    return mm(o.reshape(s, h * hd), w["mixer.wo"].reshape(h * hd, d), quant)


def mamba(w: Dict[str, torch.Tensor], x: torch.Tensor, dims: Dims, quant: Quant) -> torch.Tensor:
    s = x.shape[0]
    di, n, dtr, kc = dims.d_inner, dims.d_state, dims.dt_rank, dims.d_conv
    xz = mm(x, w["mixer.in_proj"], quant)
    xs, z = xz[:, :di], xz[:, di:]
    xp = torch.cat([xs.new_zeros(kc - 1, di), xs])
    conv = sum(xp[i:i + s] * w["mixer.conv_w"][i] for i in range(kc)) + w["mixer.conv_b"]
    u = F.silu(conv)
    proj = mm(u, w["mixer.x_proj"], quant)
    dt = F.softplus(mm(proj[:, :dtr], w["mixer.dt_proj"], quant) + w["mixer.dt_bias"])
    b, c = proj[:, dtr:dtr + n], proj[:, dtr + n:]
    a = -torch.exp(w["mixer.A_log"])  # [di, n]
    abar = torch.exp(dt[:, :, None] * a)  # [S, di, n]
    bx = (dt * u)[:, :, None] * b[:, None, :]
    hstate = x.new_zeros(di, n)
    ys = []
    for t in range(s):
        hstate = abar[t] * hstate + bx[t]
        ys.append(hstate @ c[t])
    y = torch.stack(ys) + w["mixer.D"] * u
    return mm(y * F.silu(z), w["mixer.out_proj"], quant)


def swiglu(x, wg, wu, wd, quant: Quant) -> torch.Tensor:
    return mm(F.silu(mm(x, wg, quant)) * mm(x, wu, quant), wd, quant)


def moe(w: Dict[str, torch.Tensor], x: torch.Tensor, dims: Dims, quant: Quant) -> torch.Tensor:
    probs = torch.softmax(mm(x, w["ffn.router"], quant), dim=-1)
    top_w, top_i = torch.topk(probs, dims.top_k, dim=-1)
    if dims.norm_topk_prob:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in torch.unique(top_i).tolist():
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        out = swiglu(x[rows], w["ffn.w_gate"][e], w["ffn.w_up"][e], w["ffn.w_down"][e], quant)
        y.index_add_(0, rows, out * top_w[rows, slot][:, None])
    for j in range(dims.n_shared):
        y = y + swiglu(x, w["ffn.shared.w_gate"][j], w["ffn.shared.w_up"][j],
                       w["ffn.shared.w_down"][j], quant)
    return y


MIXERS = {"mla": mla, "attn": gqa, "mamba": mamba}


def block(w: Dict[str, torch.Tensor], x: torch.Tensor, dims: Dims, i: int,
          quant: Quant) -> torch.Tensor:
    """Layer `i` as a pre-norm residual block of its signature's mixer and FFN."""
    mixer, ffn = dims.sigs[i]
    x = x + MIXERS[mixer](w, rmsnorm(x, w["norm1.scale"], dims.norm_eps), dims, quant)
    h = rmsnorm(x, w["norm2.scale"], dims.norm_eps)
    if ffn == "dense":
        return x + swiglu(h, w["ffn.w_gate"], w["ffn.w_up"], w["ffn.w_down"], quant)
    return x + moe(w, h, dims, quant)


