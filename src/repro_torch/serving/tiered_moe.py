"""Tiered MoE execution (port of repro/serving/tiered_moe.py).

Expert weights live in three buffers, hot [n_hot, 3, D, F], warm
[n_warm, 3, D, F] and cold [n_cold_slots, 3, D, F] (gate, up and the
TRANSPOSED down matrix per slot), addressed through the routing tables
expert_tier[E] / expert_slot[E]. Each MoE layer dispatches its
assignments per tier into [n_slots, cap, D] buffers, runs the tier's
expert FFN (kernels/expert_gemv on decode steps, kernels/moe_gemm on
prefill chunks, reading the buffer views in place) and combines.
Migrations swap weights between buffers in place between steps.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.hardware import TPU_V5E
from repro_torch.models.layers import Params, dense_init, torch_dtype
from repro_torch.models.moe import expert_ffn, moe_backend, router_topk, shared_ffn

HOT_T, WARM_T, COLD_T = 0, 1, 2
TIER_KEYS = ("hot", "warm", "cold")


def tier_occupancy(tiers, ema=None) -> Dict[str, float]:
    """Per-tier expert counts of a [L, E] (or [E]) tier array, plus the
    predicted load mass per tier when the predictor's EMA is given (the
    tier-timeline counter tracks of repro_torch.obs)."""
    t = np.asarray(tiers)
    out: Dict[str, float] = {}
    for tid, key in enumerate(TIER_KEYS):
        mask = t == tid
        out[f"{key}_experts"] = int(mask.sum())
        if ema is not None:
            out[f"{key}_load"] = float(np.asarray(ema)[mask].sum())
    return out


class TierSizes(NamedTuple):
    n_hot: int
    n_warm: int
    n_cold: int


def validate_tier_sizes(cfg, sizes: TierSizes) -> TierSizes:
    """Reject impossible tier splits before any buffer is allocated."""
    n_hot, n_warm, n_cold = sizes
    e = cfg.moe.n_experts
    if n_hot < 1 or n_warm < 0 or n_cold < 0:
        raise ValueError(
            f"invalid tier sizes {tuple(sizes)}: need n_hot >= 1 and "
            f"non-negative warm/cold"
        )
    if n_hot + n_warm > e:
        raise ValueError(
            f"impossible tier split: n_hot + n_warm = {n_hot + n_warm} "
            f"exceeds n_experts = {e}"
        )
    if n_hot + n_warm + n_cold != e:
        raise ValueError(
            f"tier sizes {tuple(sizes)} sum to {n_hot + n_warm + n_cold}, "
            f"expected n_experts = {e}"
        )
    return sizes


def tier_sizes(cfg, n_chips: Optional[int] = None, hbm_budget_frac: float = 0.15,
               reclaimed_kv_bytes: int = 0) -> TierSizes:
    """Size the tiers as the reference does (same TPU_V5E HBM budget, so
    the split equals the JAX package's): the replicated hot buffer fits
    its HBM budget plus the KV bytes the paged cache reclaimed, warm is
    ~30% of the experts, everything else is cold. `n_chips` (the devices
    the warm and cold tiers spread over) defaults to the process group's
    world size, or 1 without one (the reference reads jax.device_count())."""
    if n_chips is None:
        n_chips = dist.get_world_size() if dist.is_initialized() else 1
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    mo = cfg.moe
    w_bytes = 3 * cfg.d_model * mo.d_expert * 2
    n_moe_layers = max(1, sum(cfg.uses_moe_layer(i) for i in range(cfg.n_layers)))
    budget = TPU_V5E.hbm_bytes * hbm_budget_frac + max(0, reclaimed_kv_bytes)
    n_hot = max(1, min(mo.n_experts // 4, int(budget / (w_bytes * n_moe_layers))))
    n_warm = max(1, min(mo.n_experts - n_hot - 1, int(round(0.30 * mo.n_experts))))
    n_cold = mo.n_experts - n_hot - n_warm
    return validate_tier_sizes(cfg, TierSizes(n_hot, n_warm, n_cold))


def init_tiered_state(gen: torch.Generator, cfg, sizes: TierSizes,
                      pad_cold_to: int = 16, lead=()) -> Params:
    """Tier buffers + routing tables for one MoE layer (or `lead`-stacked
    layers). Initial assignment: experts [0, n_hot) hot, then warm, then
    cold; the cold buffer is padded to a multiple of `pad_cold_to` slots
    (the padding slots hold random weights that migrations may move)."""
    mo = cfg.moe
    d, f = cfg.d_model, mo.d_expert
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    validate_tier_sizes(cfg, TierSizes(*sizes))
    n_hot, n_warm, n_cold = sizes
    n_cold_slots = -(-n_cold // pad_cold_to) * pad_cold_to
    tier = torch.tensor([HOT_T] * n_hot + [WARM_T] * n_warm + [COLD_T] * n_cold,
                        dtype=torch.int32, device=dev)
    slot = torch.tensor(list(range(n_hot)) + list(range(n_warm)) + list(range(n_cold)),
                        dtype=torch.int32, device=dev)
    lead = tuple(lead)
    return {
        "hot": dense_init(gen, (n_hot, 3, d, f), dt, lead=lead),
        "warm": dense_init(gen, (n_warm, 3, d, f), dt, lead=lead),
        "cold": dense_init(gen, (n_cold_slots, 3, d, f), dt, lead=lead),
        "expert_tier": tier.expand(*lead, -1).clone(),
        "expert_slot": slot.expand(*lead, -1).clone(),
    }


def _tier_ffn(w: torch.Tensor, h: torch.Tensor, backend: str, decode: bool):
    """w: [n, 3, D, F] tier buffer; h: [n, C, D] -> [n, C, D]. The
    kernels read gate, up and the transposed down matrix as views."""
    return expert_ffn(h, w[:, 0], w[:, 1], w[:, 2].transpose(1, 2),
                      backend=backend, decode=decode)


def _dispatch_tier(flat, st, tier_slot, in_tier, n_slots: int, cap: int):
    """Scatter this tier's assignments into [n_slots, cap, D] buffers.
    Returns (buffers, dst [t*k] row of each assignment, ok [t*k])."""
    n, d = st.shape[0], flat.shape[1]
    key = torch.where(in_tier, tier_slot, torch.full_like(tier_slot, n_slots)).long()
    ks, order = torch.sort(key, stable=True)
    ar = torch.arange(n, device=flat.device)
    pos_sorted = ar - torch.searchsorted(ks, ks, side="left")
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    ok = in_tier & (pos < cap)
    dst = torch.where(ok, key * cap + pos, torch.full_like(key, n_slots * cap))
    buf = torch.zeros((n_slots * cap + 1, d), dtype=flat.dtype, device=flat.device)
    # pad/over-capacity assignments all land on the discarded last row
    buf[dst] = flat[st]
    return buf[: n_slots * cap].reshape(n_slots, cap, d), dst, ok


def tiered_moe_forward(
    p: Params,  # this layer's ffn params: router (+ shared)
    state: Params,  # tier buffers + routing tables
    cfg,
    x: torch.Tensor,  # [B, S, D] (decode: S == 1)
    cold_capacity_frac: float = 0.25,
    token_mask: Optional[torch.Tensor] = None,  # [B, S] or [B*S] bool
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, D], expert_counts [E] int32). Masked tokens are
    excluded from dispatch and counts; the cold tier runs at
    `cold_capacity_frac` of the dropless capacity (1.0 = dropless)."""
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    kind = moe_backend(cfg, backend)
    t = b * s
    flat = x.reshape(t, d)
    logits = flat.float() @ p["router"]
    _, w, idx = router_topk(logits, k)

    a_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    a_exp = idx.reshape(-1)
    a_w = w.reshape(-1)
    a_live = None
    if token_mask is not None:
        a_live = token_mask.reshape(t).repeat_interleave(k)
    a_tier = state["expert_tier"][a_exp]
    a_slot = state["expert_slot"][a_exp].long()

    contrib = None  # [t*k, D]: each assignment's weighted expert output
    for tid, key in enumerate(TIER_KEYS):
        n_slots = state[key].shape[0]
        cap = t if tid != COLD_T else max(mo.top_k, int(t * cold_capacity_frac + 0.999))
        in_tier = a_tier == tid
        if a_live is not None:
            in_tier = in_tier & a_live
        h, dst, ok = _dispatch_tier(flat, a_tok, a_slot, in_tier, n_slots, cap)
        o = _tier_ffn(state[key], h, kind, decode=(s == 1))
        obuf = torch.cat([o.reshape(n_slots * cap, d), o.new_zeros((1, d))])
        c = obuf[dst] * (a_w * ok).to(o.dtype)[:, None]
        # an assignment lives in one tier: the other tiers add exact zeros
        contrib = c if contrib is None else contrib + c
    # combine: each token's k contributions summed in order, in x's dtype
    # (the reference's y.at[a_tok].add), with no atomics
    ck = contrib.reshape(t, k, d)
    y = ck[:, 0]
    for j in range(1, k):
        y = y + ck[:, j]
    y = y.reshape(b, s, d).to(x.dtype)
    if mo.n_shared:
        y = y + shared_ffn(p["shared"], x)
    one = (torch.ones_like(a_exp, dtype=torch.int32) if a_live is None
           else a_live.to(torch.int32))
    counts = torch.zeros((e,), dtype=torch.int32, device=x.device).index_add_(0, a_exp, one)
    return y, counts


# ------------------------------------------------------------ migrations
def apply_migrations(state: Params, plan) -> Params:
    """Execute a migration plan IN PLACE (rows padded with no-ops).

    plan: [M, 5] int rows (expert_a, tier_a, slot_a, tier_b, slot_b):
    swap the weights at (tier_a, slot_a) and (tier_b, slot_b) and update
    the routing tables of the two experts involved; a row with
    expert_a < 0 is a no-op. `state` may hold views of one scan group of
    a stacked state; the writes land in the stack. As in the reference,
    the expert found at (tier_b, slot_b) is the first match, or expert 0
    when the slot is empty (a cold padding slot)."""
    bufs = [state["hot"], state["warm"], state["cold"]]
    tier, slot = state["expert_tier"], state["expert_slot"]
    for row in np.asarray(plan):
        ea, ta, sa, tb, sb = (int(v) for v in row)
        if ea < 0:
            continue
        wa = bufs[ta][sa].clone()
        wb = bufs[tb][sb].clone()
        bufs[ta][sa] = wb
        bufs[tb][sb] = wa
        occupant_b = torch.argmax(((tier == tb) & (slot == sb)).to(torch.int32))
        tier[ea] = tb
        tier[occupant_b] = ta
        slot[ea] = sb
        slot[occupant_b] = sa
    return state
