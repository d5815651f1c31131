"""Tiered MoE execution (port of repro/serving/tiered_moe.py).

Expert weights live in three buffers, hot [n_hot, 3, D, F], warm
[n_warm, 3, D, F] and cold [n_cold_slots, 3, D, F] (gate, up and the
TRANSPOSED down matrix per slot), addressed through the routing tables
expert_tier[E] / expert_slot[E]. Each MoE layer dispatches its
assignments per tier into [n_slots, cap, D] buffers, runs the tier's
expert FFN (kernels/expert_gemv on decode steps, kernels/moe_gemm on
prefill chunks, reading the buffer views in place) and combines.
Migrations swap weights between buffers in place between steps.
A decode call on a card replays a CUDA graph of that work
(`DecodeGraphs`): one graph launch instead of ~60 small ones.
A layer may hold a share of an expert-parallel layer's experts
(`MoEConfig.held_from`, `n_routed`): the router scores every routed
expert, and only assignments to the held ones are dispatched, weighted
and counted ([E] counts over the experts held).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import refuse_on_mesh
from repro_torch.hardware import TPU_V5E
from repro_torch.kernels.backend import wants_grad
from repro_torch.kernels.expert_gemv.kernel import expert_ffn_gemv
from repro_torch.models.layers import Params, dense_init, torch_dtype
from repro_torch.models.moe import (
    expert_ffn,
    held_ids,
    moe_backend,
    route,
    router_topk,
    shared_ffn,
)
from repro_torch.obs.trace import NULL_SPAN, active_tracer, install_tracer

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
    """Reject impossible tier splits before any buffer is allocated: the
    tiers hold the experts held here (`n_experts`, a share of the routed
    ones under expert parallelism)."""
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


def slot_positions(key: torch.Tensor) -> torch.Tensor:
    """Each assignment's rank among the earlier ones with its key."""
    ks, order = torch.sort(key, stable=True)
    ar = torch.arange(key.shape[0], device=key.device)
    pos_sorted = ar - torch.searchsorted(ks, ks, side="left")
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def _dispatch_tier(flat, st, tier_slot, in_tier, n_slots: int, cap: int, pos=None):
    """Scatter this tier's assignments into [n_slots, cap, D] buffers, each
    at its rank among the slot's assignments (`pos`: given, or counted
    here). Returns (buffers, dst [t*k] row of each assignment, ok [t*k])."""
    d = flat.shape[1]
    key = torch.where(in_tier, tier_slot, torch.full_like(tier_slot, n_slots)).long()
    if pos is None:
        pos = slot_positions(key)
    ok = in_tier & (pos < cap)
    dst = torch.where(ok, key * cap + pos, torch.full_like(key, n_slots * cap))
    buf = torch.zeros((n_slots * cap + 1, d), dtype=flat.dtype, device=flat.device)
    # pad/over-capacity assignments all land on the discarded last row
    buf[dst] = flat[st]
    return buf[: n_slots * cap].reshape(n_slots, cap, d), dst, ok


def _cold_capacity(t: int, k: int, cold_capacity_frac: float) -> int:
    return max(k, int(t * cold_capacity_frac + 0.999))


def tiered_moe_forward(
    p: Params,  # this layer's ffn params: router (+ shared)
    state: Params,  # tier buffers + routing tables
    cfg,
    x: torch.Tensor,  # [B, S, D] (decode: S == 1)
    cold_capacity_frac: float = 0.25,
    token_mask: Optional[torch.Tensor] = None,  # [B, S] or [B*S] bool
    backend: Optional[str] = None,
    layer: Optional[int] = None,  # the layer's index: the `moe` span's arg
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, D], expert_counts [E] int32), tensors of the
    call's own. Masked tokens are excluded from dispatch and counts; the
    cold tier runs at `cold_capacity_frac` of the dropless capacity (1.0 =
    dropless). A decode call (S == 1) on a card that autograd does not
    record replays a CUDA graph of the body (`DecodeGraphs`), captured at
    its key's first call; prefill and verify chunks, the CPU and calls
    made inside another capture run eagerly. With a tracer installed
    (repro_torch.obs.trace) the call is a `moe` span, its `graph` arg
    "eager", "capture" or "replay"; an eager call's span holds
    `moe.route` (router, top-k, tier and slot lookup), one `moe.tier` per
    tier (dispatch, the expert FFN, the gather) and `moe.combine` (the
    combine and the shared experts). A capture or replay emits nothing
    inside its span: no Python runs the body's parts one by one."""
    tr = active_tracer()
    key = DECODE_GRAPHS.key(p, state, cfg, x, cold_capacity_frac, token_mask, backend)
    mode = "eager" if key is None else "replay" if key in DECODE_GRAPHS else "capture"
    mo = cfg.moe
    with (tr.span("moe", cat="moe", layer=layer, tokens=x.shape[0] * x.shape[1], graph=mode,
                  held=f"{mo.held_from}-{mo.held_from + mo.n_experts - 1}/{mo.routed}",
                  router=mo.router)
          if tr else NULL_SPAN):
        if mode == "eager":
            return _tiered_moe(p, state, cfg, x, cold_capacity_frac, token_mask, backend, tr)
        if mode == "replay":
            return DECODE_GRAPHS.replay(key, x, token_mask)
        return DECODE_GRAPHS.capture(
            key, lambda xs, ms: _tiered_moe(p, state, cfg, xs, cold_capacity_frac, ms, backend,
                                            None), x, token_mask)


def _tiered_moe(p, state, cfg, x, cold_capacity_frac, token_mask, backend, tr):
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    kind = moe_backend(cfg, backend)
    t = b * s
    flat = x.reshape(t, d)
    with (tr.span("moe.route", cat="moe", groups=f"{mo.topk_group}/{mo.n_group}")
          if tr else NULL_SPAN):
        logits = flat.float() @ p["router"]
        # the softmax router is called by its name here, where the parity
        # tests record the tiered path's router scores
        if mo.router == "softmax":
            _, w, idx = router_topk(logits, k)
        else:
            _, w, idx = route(p, mo, logits)
        idx, held = held_ids(mo, idx)
        # each token's k assignments in a row (no host sync: capturable)
        a_tok = torch.arange(t * k, device=x.device) // k
        a_exp = idx.reshape(-1)
        a_w = w.reshape(-1)
        a_live = None
        if token_mask is not None:
            a_live = token_mask.reshape(t)[a_tok]
        if held is not None:  # experts held elsewhere: not live here
            a_live = held.reshape(-1) if a_live is None else a_live & held.reshape(-1)
        a_tier = state["expert_tier"][a_exp]
        a_slot = state["expert_slot"][a_exp].long()

    contrib = None  # [t*k, D]: each assignment's weighted expert output
    for tid, key in enumerate(TIER_KEYS):
        with tr.span("moe.tier", cat="moe", tier=key) if tr else NULL_SPAN:
            n_slots = state[key].shape[0]
            cap = t if tid != COLD_T else _cold_capacity(t, mo.top_k, cold_capacity_frac)
            in_tier = a_tier == tid
            if a_live is not None:
                in_tier = in_tier & a_live
            h, dst, ok = _dispatch_tier(flat, a_tok, a_slot, in_tier, n_slots, cap)
            o = _tier_ffn(state[key], h, kind, decode=(s == 1))
            obuf = torch.cat([o.reshape(n_slots * cap, d), o.new_zeros((1, d))])
            c = obuf[dst] * (a_w * ok).to(o.dtype)[:, None]
            # an assignment lives in one tier: the other tiers add exact zeros
            contrib = c if contrib is None else contrib + c
    with tr.span("moe.combine", cat="moe") if tr else NULL_SPAN:
        y = _combine(contrib, x, k)
        if mo.n_shared:
            y = y + shared_ffn(p["shared"], x)
    return y, _counts(a_exp, a_live, e)


def _combine(contrib: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k contributions [t*k, D] summed in order, in x's dtype
    (the reference's y.at[a_tok].add), with no atomics: [B, S, D]."""
    ck = contrib.reshape(-1, k, x.shape[-1])
    y = ck[:, 0]
    for j in range(1, k):
        y = y + ck[:, j]
    return y.reshape(x.shape).to(x.dtype)


def _counts(a_exp: torch.Tensor, a_live, e: int) -> torch.Tensor:
    """Live assignments per expert [E] int32."""
    one = (torch.ones_like(a_exp, dtype=torch.int32) if a_live is None
           else a_live.to(torch.int32))
    return torch.zeros((e,), dtype=torch.int32, device=a_exp.device).index_add_(0, a_exp, one)


# ------------------------------------------------------- decode graphs
class _Graph(NamedTuple):
    """One captured decode call: the graph, its static input (x, mask)
    and output (y, counts) buffers, and the GEMV launches it holds."""
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    mask: Optional[torch.Tensor]
    y: torch.Tensor
    counts: torch.Tensor
    launches: int


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def graph_key(p, state, cfg, x, cold_capacity_frac, token_mask, backend) -> tuple:
    """What a decode call's graph depends on: the address, shape, strides
    and dtype of every tensor its body reads (router, shared experts,
    tier buffers, routing tables), x's shape, dtype and device, the mask's
    dtype (or its absence) and the settings the body branches on."""
    mo = cfg.moe
    # routing other than the default softmax over every expert held
    routing = (() if mo.router == "softmax" and not mo.holds_share else
               (mo.router, mo.n_group, mo.topk_group, mo.routed_scale, mo.routed, mo.held_from))
    return (tuple(x.shape), x.dtype, x.device,
            None if token_mask is None else token_mask.dtype,
            float(cold_capacity_frac), moe_backend(cfg, backend),
            mo.n_experts, mo.top_k, mo.n_shared,
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in _leaves(p) + _leaves(state))) + routing


class DecodeGraphs:
    """CUDA graphs of `tiered_moe_forward`'s decode calls, one per
    `graph_key`, captured at the key's first call and replayed at every
    later one. Migrations write the tier buffers and routing tables in
    place, so a replay reads the current layout; a rebound tensor gives a
    new key. All graphs share one memory pool: replays run in order on
    one stream, so their intermediates may share memory, while each graph
    keeps its static buffers. A replay copies x (and the mask) into the
    graph's inputs and returns clones of its outputs: the loop keeps a
    step's counts while the other zigzag group's step replays the same
    graph."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def clear(self) -> None:
        """Drop every graph. Their pool goes with them (its memory returns
        to the cache), so later captures start a new one."""
        self._graphs.clear()
        self._pool = None

    @staticmethod
    def key(p, state, cfg, x, cold_capacity_frac, token_mask, backend) -> Optional[tuple]:
        """The call's `graph_key`, or None where the call runs eagerly:
        not a decode call, not on a card, recorded by autograd, or made
        while the stream captures (an enclosing capture takes it as is)."""
        if x.shape[1] != 1 or not x.is_cuda or torch.cuda.is_current_stream_capturing():
            return None
        if wants_grad(x, *_leaves(p), *_leaves(state)):
            return None
        return graph_key(p, state, cfg, x, cold_capacity_frac, token_mask, backend)

    def replay(self, key, x: torch.Tensor, token_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        g = self._graphs[key]
        g.x.copy_(x)
        if g.mask is not None:
            g.mask.copy_(token_mask.reshape(-1))
        g.graph.replay()
        expert_ffn_gemv.launches += g.launches
        return g.y.clone(), g.counts.clone()

    def capture(self, key, body, x: torch.Tensor, token_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """A key's first call: `body(x, mask)` run eagerly on the capture
        stream (the call's result, and the warm-up a capture needs), then
        captured there into the shared pool. Neither emits a span."""
        cur = torch.cuda.current_stream(x.device)
        side = self._streams.get(x.device)
        if side is None:
            side = self._streams[x.device] = torch.cuda.Stream(x.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        sx = x.clone(memory_format=torch.contiguous_format)
        smask = None if token_mask is None else token_mask.reshape(-1).clone()
        tr = active_tracer()
        if tr is not None:
            install_tracer(None)
        side.wait_stream(cur)
        try:
            with torch.cuda.stream(side):
                y, counts = body(sx, smask)
                n0 = expert_ffn_gemv.launches
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=self._pool)
                try:
                    gy, gcounts = body(sx, smask)
                finally:
                    graph.capture_end()
                # a capture launches nothing: each replay counts the launches
                launches, expert_ffn_gemv.launches = expert_ffn_gemv.launches - n0, n0
        finally:
            if tr is not None:
                install_tracer(tr)
        cur.wait_stream(side)
        y.record_stream(cur)
        counts.record_stream(cur)
        self._graphs[key] = _Graph(graph, sx, smask, gy, gcounts, launches)
        return y, counts


# the process's decode graphs: one pool for every layer's calls
DECODE_GRAPHS = DecodeGraphs()


# ------------------------------------------------------ on a device mesh
def tiered_moe_forward_mesh(tp, p, state, cfg, x: torch.Tensor, cold_capacity_frac: float = 0.25,
                            token_mask: Optional[torch.Tensor] = None,
                            backend: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`tiered_moe_forward` on a serving mesh (`tp`; p's and state's
    leaves `Local`, x this rank's rows), each tier computed where
    `tiered_pspec` puts it:
    - hot (replicated, the GPU): this rank's rows on every expert;
    - warm (F striped over "model", the AMX-CPU): this rank's rows on its
      F/m columns of every expert; SiLU is per column, so the partial
      down products sum exactly over "model";
    - cold (expert slots homed over data x model, or over data with F
      striped: DIMM-NDP): the tokens travel to the experts. The rows are
      gathered over the home axes' DP part, each rank runs the slots it
      homes and the outputs go back by one reduce-scatter (and a sum over
      "model"). Capacity is the global token count's and each
      assignment's place in its slot the global order's (every DP shard's
      slot keys gathered), so drops fall where the one program drops them.
      Rows replicated over DP (a batch that does not split: `tp.split`
      false) stay put: each home runs its slots on every row and the
      homes' outputs are summed.
    Returns (y [B, S, D], expert_counts [E] int32 summed over the DP
    shards: the whole batch's, replicated rows counted once)."""
    from repro_torch.distributed import tensor_parallel as tpl

    refuse_on_mesh(cfg, "the tiered MoE")
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    kind = moe_backend(cfg, backend)
    t = b * s
    flat = x.reshape(t, d)
    _, w, idx = router_topk(tpl.router_logits(tp, flat, p["router"]), k)

    a_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    a_exp = idx.reshape(-1)
    a_w = w.reshape(-1)
    a_live = None
    if token_mask is not None:
        a_live = token_mask.reshape(t).repeat_interleave(k)
    a_tier = state["expert_tier"].t[a_exp]
    a_slot = state["expert_slot"].t[a_exp].long()

    contrib = None
    for tid, key in enumerate(TIER_KEYS):
        buf = state[key]
        in_tier = a_tier == tid
        if a_live is not None:
            in_tier = in_tier & a_live
        if tid == COLD_T:
            c = _cold_mesh(tp, buf, flat, a_w, a_slot, in_tier,
                           _cold_capacity(t * tp.n_dp, k, cold_capacity_frac), kind, s == 1, k)
        else:
            if buf.axes not in ({}, {"model": 3}):
                raise ValueError(f"the {key} tier split as {buf.axes}")
            n_slots = buf.t.shape[0]
            h, dst, ok = _dispatch_tier(flat, a_tok, a_slot, in_tier, n_slots, t)
            o = _tier_ffn(buf.t, h, kind, decode=(s == 1))
            obuf = torch.cat([o.reshape(n_slots * t, d), o.new_zeros((1, d))])
            c = obuf[dst] * (a_w * ok).to(o.dtype)[:, None]
            if "model" in buf.axes:  # F columns: partial down products
                c = tp.sum_model(c)
        contrib = c if contrib is None else contrib + c
    y = _combine(contrib, x, k)
    if mo.n_shared:
        y = y + tpl.shared_ffn(tp, p["shared"], x)
    return y, tp.sum_dp(_counts(a_exp, a_live, e))


def _cold_mesh(tp, buf, flat, a_w, a_slot, in_tier, cap: int, kind: str, decode: bool, k: int):
    """The cold tier's contributions [t*k, D] to this rank's assignments
    (see `tiered_moe_forward_mesh`). `buf` [n_slots, 3, D, F] as
    `tiered_pspec` splits it: slots over data x model or data, F over
    "model", or neither."""
    n_slots = buf.shape[0]
    homes = tuple(a for a, dim in buf.axes.items() if dim == 0)
    f_split = buf.axes.get("model") == 3
    if set(buf.axes) - set(homes) - ({"model"} if f_split else set()):
        raise ValueError(f"the cold tier split as {buf.axes}")
    tk, d = a_slot.shape[0], flat.shape[1]
    # every DP shard's slot keys: positions in the global assignment order
    key = torch.where(in_tier, a_slot, torch.full_like(a_slot, n_slots))
    keys = tp.gather_dp(key).reshape(-1)
    pos_all = slot_positions(keys)
    # the rows travel over the home axes' DP part (the data shards of this
    # pod); rows replicated on every DP shard stay where they are
    home_dp = tp.group(tuple(a for a in homes if a != "model"))
    grp = home_dp if tp.split else (None, 1, 0)
    _, n_g, i_g = grp
    first = (tp.dp_i - i_g) * tk
    keys_g = keys[first:first + n_g * tk]
    flat_g = tp.all_gather(flat, grp)
    n_local = buf.t.shape[0]
    _, _, home = tp.group(homes)
    lo = home * n_local
    mine = (keys_g >= lo) & (keys_g < lo + n_local)
    a_tok_g = torch.arange(flat_g.shape[0], device=flat.device).repeat_interleave(k)
    h, dst, ok = _dispatch_tier(flat_g, a_tok_g, keys_g - lo, mine, n_local, cap,
                                pos=pos_all[first:first + n_g * tk])
    o = _tier_ffn(buf.t, h, kind, decode)
    obuf = torch.cat([o.reshape(n_local * cap, d), o.new_zeros((1, d))])
    out = tp.reduce_scatter(obuf[dst], grp)  # back to the shards the rows came from
    if not tp.split:  # every home ran its slots on every row: sum them
        out = tp.all_reduce(out, home_dp)
    if "model" in homes or f_split:
        out = tp.sum_model(out)
    pos = pos_all[tp.dp_i * tk:(tp.dp_i + 1) * tk]
    return out * (a_w * (in_tier & (pos < cap))).to(out.dtype)[:, None]


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
