"""Routed MoE layer (port of repro/models/moe.py): `MoEOutput` :34,
`init_moe` :61, `router_topk` :82, `moe_backend` :90, `expert_ffn`
:109, `shared_ffn` :129, and the flat `moe_forward` :136 with its two
dispatches, `_moe_forward_global` :181 and `_moe_forward_grouped` :249.

Dispatch is scatter/gather, not a one-hot einsum: assignments sort by
expert id (stable), land in capacity-bounded expert buffers, run the
expert FFN, and are combined back weighted by their router weights. The
expert FFN routes by shape: decode buffers (S == 1, a few tokens per
expert, weight-read bound) go to the batched expert GEMV
(kernels/expert_gemv), everything else to the grouped MoE GEMM
(kernels/moe_gemm). Either resolves CUDA kernel vs plain version
through kernels/backend.py with `cfg.moe_backend`.

The reference's `set_moe_sharding_hints` / `_hint` pin the grouped
dispatch's buffers to a device mesh; on one device they do nothing, so
they are left to the distributed slice.

Returns per-expert token counts beside the output: the load signal
the TriMoE predictor and scheduler (core/) consume.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.expert_gemv import cold_expert_ffn
from repro_torch.kernels.moe_gemm import grouped_expert_ffn
from repro_torch.models.layers import Params, dense_init, torch_dtype


class MoEOutput(NamedTuple):
    y: torch.Tensor  # [B, S, D]
    aux_loss: torch.Tensor  # scalar load-balance loss (fp32)
    expert_counts: torch.Tensor  # [E] int32 tokens routed per expert


def init_moe(gen: torch.Generator, cfg, lead=()) -> Params:
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_expert, mo.n_experts
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "router": dense_init(gen, (d, e), torch.float32, lead=lead),
        "w_gate": dense_init(gen, (e, d, f), dt, lead=lead),
        "w_up": dense_init(gen, (e, d, f), dt, lead=lead),
        "w_down": dense_init(gen, (e, f, d), dt, lead=lead),
    }
    if mo.n_shared:
        p["shared"] = {
            "w_gate": dense_init(gen, (mo.n_shared, d, f), dt, lead=lead),
            "w_up": dense_init(gen, (mo.n_shared, d, f), dt, lead=lead),
            "w_down": dense_init(gen, (mo.n_shared, f, d), dt, lead=lead),
        }
    return p


def router_topk(logits: torch.Tensor, k: int):
    """Softmax-then-topk with renormalized weights (DeepSeek-style)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return probs, w, idx


def moe_backend(cfg, backend: str | None = None) -> str:
    """The expert-FFN backend choice: an explicit `backend` overrides
    `cfg.moe_backend` (validated by the kernels/backend.py rule)."""
    return resolve_backend(backend or cfg.moe_backend, knob="moe_backend")


def expert_ffn(h, w_gate, w_up, w_down, *, backend: str = "auto",
               decode: bool = False, group_expert=None) -> torch.Tensor:
    """Expert FFN over dispatched buffers h [G, C, D] with weights
    w_gate/w_up [E, D, F], w_down [E, F, D] (any strides): decode
    buffers hit the batched GEMV, everything else the grouped GEMM.
    `group_expert` [G] maps buffer groups to expert weight rows when
    G != E (the per-row dispatch's [B*E] groups)."""
    if decode and group_expert is None:
        return cold_expert_ffn(h, w_gate, w_up, w_down, backend=backend)
    return grouped_expert_ffn(h, w_gate, w_up, w_down, group_expert, backend=backend)


def shared_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"])
    a = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsef,efd->bsd", a, p["w_down"])


def moe_forward(p: Params, cfg, x: torch.Tensor, *, capacity_factor=None,
                full_capacity: bool = False, grouped: bool | None = None,
                token_mask: torch.Tensor | None = None,
                backend: str | None = None) -> MoEOutput:
    """Routed MoE over x [B, S, D]. The global dispatch (the default, as
    in the reference) sorts all B*S*k assignments at once; the grouped
    one sorts each batch row's own and runs [B*E] buffer groups over the
    shared [E, D, F] weights. `full_capacity` makes the dispatch dropless
    (capacity = all tokens); otherwise each expert takes at most
    min(T, max(k, int(T*k*cf/E + 0.5))) assignments, T the tokens sorted
    together. `token_mask` [B, S] excludes masked tokens from dispatch,
    counts and the aux loss: their assignments take the sentinel expert
    id E, so the stable sort parks them after every real one. `backend`
    overrides `cfg.moe_backend` for this call."""
    kind = moe_backend(cfg, backend)
    fwd = _moe_forward_grouped if grouped else _moe_forward_global
    return fwd(p, cfg, x, capacity_factor, full_capacity, token_mask, kind)


def _capacity(n: int, k: int, e: int, cf: float) -> int:
    return min(n, max(k, int(n * k * cf / e + 0.5)))


def _aux_and_counts(mo, probs, a_exp, live, n_tokens: int, token_mask):
    """Switch-style load-balance loss and expert counts [E] int32 over the
    flat assignments `a_exp` ([n_tokens * k]); with `live` (the
    assignments' token mask) only live tokens count."""
    e, k = mo.n_experts, mo.top_k
    probs = probs.reshape(-1, e)
    ones = torch.ones_like(a_exp, dtype=torch.int32) if live is None else live.to(torch.int32)
    counts = torch.zeros(e, dtype=torch.int32, device=probs.device).index_add_(0, a_exp, ones)
    if live is None:
        frac_tokens = counts.float() / (n_tokens * k)
        frac_probs = probs.mean(0)
    else:
        tm = token_mask.reshape(-1)
        n_live = torch.clamp(tm.sum().float(), min=1.0)
        frac_tokens = counts.float() / (n_live * k)
        frac_probs = (probs * tm[:, None]).sum(0) / n_live
    return mo.router_aux_coef * e * torch.sum(frac_tokens * frac_probs), counts


def _moe_forward_global(p, cfg, x, capacity_factor, full_capacity, token_mask=None,
                        kind: str = "auto") -> MoEOutput:
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    t = b * s
    cf = capacity_factor if capacity_factor is not None else mo.capacity_factor
    cap = t if full_capacity else _capacity(t, k, e, cf)

    flat = x.reshape(t, d)
    probs, w, idx = router_topk(flat.float() @ p["router"], k)
    live = None if token_mask is None else token_mask.reshape(t).repeat_interleave(k)

    # flatten (token, expert) assignments and sort them by expert
    a_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    a_exp = idx.reshape(-1)
    a_key = a_exp if live is None else torch.where(live, a_exp, e)
    order = torch.argsort(a_key, stable=True)
    se, st, sw = a_key[order], a_tok[order], w.reshape(-1)[order]
    pos = torch.arange(t * k, device=x.device) - torch.searchsorted(se, se)
    keep = (pos < cap) & (se < e)
    slot = torch.where(keep, se * cap + pos, e * cap)  # the overflow row is dropped

    # index_select, not x[idx]: its backward is one index_add, where fancy
    # indexing's sorts the indices first (a third of a train step's device time)
    buf = x.new_zeros(e * cap + 1, d).index_put((slot,), flat.index_select(0, st))
    h = buf[: e * cap].reshape(e, cap, d)
    o = expert_ffn(h, p["w_gate"], p["w_up"], p["w_down"], backend=kind, decode=(s == 1))
    obuf = torch.cat([o.reshape(e * cap, d), o.new_zeros(1, d)])

    contrib = obuf.index_select(0, slot) * (sw * keep)[:, None].to(o.dtype)
    y = x.new_zeros(t, d).index_add(0, st, contrib).reshape(b, s, d)
    if mo.n_shared:
        y = y + shared_ffn(p["shared"], x)
    aux, counts = _aux_and_counts(mo, probs, a_exp, live, t, token_mask)
    return MoEOutput(y, aux, counts)


def _moe_forward_grouped(p, cfg, x, capacity_factor, full_capacity=False,
                         token_mask=None, kind: str = "auto") -> MoEOutput:
    """Per-row dispatch: [B, S, D] -> buffers [B, E, C, D] -> expert FFN
    -> combine, every sort row-local. The [B*E] buffer groups run over
    the one [E, D, F] weight tensor through group -> expert rows
    tile(arange(E), B), with no copy of the weights."""
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    cf = capacity_factor if capacity_factor is not None else mo.capacity_factor
    cap = s if full_capacity else _capacity(s, k, e, cf)

    probs, w, idx = router_topk(x.float() @ p["router"], k)  # [B, S, k]
    a_tok = torch.arange(s, device=x.device)[None, :, None].expand(b, s, k).reshape(b, s * k)
    a_exp = idx.reshape(b, s * k)
    live = None if token_mask is None else token_mask.repeat_interleave(k, dim=-1)
    a_key = a_exp if live is None else torch.where(live, a_exp, e)

    order = torch.argsort(a_key, dim=-1, stable=True)  # row-local sort
    se = torch.gather(a_key, -1, order)
    st = torch.gather(a_tok, -1, order)
    sw = torch.gather(w.reshape(b, s * k), -1, order)
    pos = torch.arange(s * k, device=x.device)[None, :] - torch.searchsorted(se, se)
    keep = (pos < cap) & (se < e)
    slot = torch.where(keep, se * cap + pos, e * cap)  # [B, S*k]

    rows = torch.arange(b, device=x.device)[:, None]
    xk = torch.gather(x, 1, st[..., None].expand(-1, -1, d))  # [B, S*k, D]
    buf = x.new_zeros(b, e * cap + 1, d).index_put((rows, slot), xk)
    h = buf[:, : e * cap].reshape(b * e, cap, d)
    ge = torch.arange(e, dtype=torch.int32, device=x.device).repeat(b)
    o = expert_ffn(h, p["w_gate"], p["w_up"], p["w_down"], backend=kind, group_expert=ge)

    obuf = torch.cat([o.reshape(b, e * cap, d), o.new_zeros(b, 1, d)], dim=1)
    contrib = torch.gather(obuf, 1, slot[..., None].expand(-1, -1, d))
    contrib = contrib * (sw * keep)[..., None].to(o.dtype)
    y = x.new_zeros(b * s, d).index_add(0, (st + rows * s).reshape(-1),
                                        contrib.reshape(-1, d)).reshape(b, s, d)
    if mo.n_shared:
        y = y + shared_ffn(p["shared"], x)
    flat_live = None if live is None else live.reshape(-1)
    aux, counts = _aux_and_counts(mo, probs, a_exp.reshape(-1), flat_live, b * s, token_mask)
    return MoEOutput(y, aux, counts)
