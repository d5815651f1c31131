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

On a device mesh (`distributed.sharding.use_mesh`) the batch rows are
split over the DP axes and each layer computes what the reference's one
program computes on the whole batch: the global dispatch ranks each
shard's assignments after those of the shards before it (an all-gather
of the per-expert counts) against the capacity of all the tokens, the
expert counts are summed over the shards, and the aux loss is the whole
batch's on every shard, its gradient each shard's own part. Where the
capacity is at most a shard's tokens, each shard places its assignments
at their global rows of the [E, capacity] buffers and the expert FFN
runs split over the DP shards by rows (a reduce-scatter of the buffers,
an all-gather of the outputs); otherwise each shard runs its own
assignments' rows, at most its token count per expert. With
`set_moe_sharding_hints` (the reference's layout constraint (dp, ep,
None, None) on the grouped buffers, :45-58) and the routed expert weights
given as this rank's E/m experts, each "model" rank runs the expert FFN
over its own experts' buffers (the grouped dispatch: [B*E/m] groups
through the GEMM's group -> expert rows) and the partial outputs are
summed over "model". Without a mesh the hints do nothing, as in the
reference.

Returns per-expert token counts beside the output: the load signal
the TriMoE predictor and scheduler (core/) consume.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import refuse_on_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import (
    GatherDim,
    ReduceScatter,
    all_gather_stack,
    all_reduce,
    copy_to_group,
    reduce_from_group,
)
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.expert_gemv import cold_expert_ffn
from repro_torch.kernels.moe_gemm import grouped_expert_ffn
from repro_torch.models.layers import Params, dense_init, torch_dtype


class MoEOutput(NamedTuple):
    y: torch.Tensor  # [B, S, D]
    aux_loss: torch.Tensor  # scalar load-balance loss (fp32)
    expert_counts: torch.Tensor  # [E] int32 tokens routed per expert


# the grouped dispatch's expert-parallel layout: (dp axes, ep axis) | None
_SHARDING_HINTS = None


def set_moe_sharding_hints(dp=("data",), ep="model", enable=True):
    global _SHARDING_HINTS
    _SHARDING_HINTS = ((dp if isinstance(dp, tuple) else (dp,)), ep) if enable else None


@contextlib.contextmanager
def moe_sharding_hints(enable: bool = True):
    """`set_moe_sharding_hints(enable=enable)` within, the previous hints
    after."""
    global _SHARDING_HINTS
    prev = _SHARDING_HINTS
    set_moe_sharding_hints(enable=enable)
    try:
        yield
    finally:
        _SHARDING_HINTS = prev


def _dp():
    """(group, size, row-shard index) of the active mesh's DP axes, or
    None without a mesh, with one shard, or with the batch whole on every
    shard (`use_mesh`'s batch does not split)."""
    mesh = shd.active_mesh()
    if mesh is None:
        return None
    dp = shd.dp_group(mesh, shd.active_batch())
    return None if dp[1] == 1 else dp


def _experts(p, e: int):
    """None when `p` holds all E routed experts; (first expert, count,
    "model" group) when it holds this rank's E/m (expert parallelism,
    which needs the hints and an active mesh)."""
    n_local = p["w_gate"].shape[-3]
    if n_local == e:
        return None
    mesh = shd.active_mesh()
    if _SHARDING_HINTS is None or mesh is None:
        raise ValueError(f"the routed expert weights hold {n_local} of {e} experts: expert "
                         f"parallelism needs set_moe_sharding_hints and an active mesh")
    group, m, idx = shd.axis_group(mesh, _SHARDING_HINTS[1])
    if n_local * m != e:
        raise ValueError(f"{n_local} local experts x {m} ranks != {e} experts")
    return idx * n_local, n_local, group


def init_moe(gen: torch.Generator, cfg, lead=()) -> Params:
    """Router [D, routed] (fp32; with the noaux_tc router its selection
    bias [routed], zeros), the held experts' weights [E, ...] and the
    shared experts'."""
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_expert, mo.n_experts
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "router": dense_init(gen, (d, mo.routed), torch.float32, lead=lead),
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
    if mo.router == "noaux_tc":
        p["router_bias"] = torch.zeros((*lead, mo.routed), dtype=torch.float32,
                                       device=gen.device)
    return p


def router_topk(logits: torch.Tensor, k: int):
    """Softmax-then-topk with renormalized weights (DeepSeek-style)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return probs, w, idx


def router_noaux_tc(logits: torch.Tensor, bias: torch.Tensor, mo):
    """DeepSeek-V3's `noaux_tc` routing of logits [T, R]: scores s =
    sigmoid(logits) in fp32; selection scores s + bias; a group of R /
    n_group experts scores the sum of its two highest; all but the
    `topk_group` best groups are masked to -inf and the top-k of the rest
    chosen; each weight is the unbiased s renormalized over the k, times
    `routed_scale`. Static shapes and no host sync (capturable). Returns
    (s normalized to sum 1 a token: the aux loss's probs, w [T, k], idx
    [T, k])."""
    s = torch.sigmoid(logits.float())
    t, r = s.shape
    choice = s + bias
    gscore = choice.reshape(t, mo.n_group, r // mo.n_group).topk(2, dim=-1).values.sum(-1)
    gidx = gscore.topk(mo.topk_group, dim=-1).indices
    keep = torch.zeros_like(gscore, dtype=torch.bool).scatter_(1, gidx, True)
    choice = choice.masked_fill(~keep.repeat_interleave(r // mo.n_group, dim=1),
                                float("-inf"))
    idx = choice.topk(mo.top_k, dim=-1).indices
    w = s.gather(1, idx)
    w = w / w.sum(-1, keepdim=True) * mo.routed_scale
    return s / s.sum(-1, keepdim=True), w, idx


def route(p: Params, mo, logits: torch.Tensor):
    """The layer's router over logits [..., routed]: (probs [..., routed],
    w [..., k], idx [..., k]) by `mo.router`."""
    if mo.router == "softmax":
        return router_topk(logits, mo.top_k)
    if mo.router == "noaux_tc":
        lead = logits.shape[:-1]
        return tuple(t.reshape(*lead, -1) for t in router_noaux_tc(
            logits.reshape(-1, logits.shape[-1]), p["router_bias"], mo))
    raise ValueError(f"unknown router {mo.router!r}")


def held_ids(mo, idx: torch.Tensor):
    """(idx as ids among the experts held, held [..., k] bool), or (idx,
    None) when every expert is held. An assignment to an expert held
    elsewhere keeps its place with held False (its id clamped to 0): the
    caller neither dispatches, weights nor counts it."""
    if not mo.holds_share:
        return idx, None
    lo, e = mo.held_from, mo.n_experts
    held = (idx >= lo) & (idx < lo + e)
    return torch.where(held, idx - lo, 0), held


def _held_probs(mo, probs: torch.Tensor) -> torch.Tensor:
    """The router's probs [..., routed] over the experts held (the aux
    loss's)."""
    return probs[..., mo.held_from:mo.held_from + mo.n_experts] if mo.holds_share else probs


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
                backend: str | None = None, logits: torch.Tensor | None = None,
                shared: bool = True, partial=None) -> MoEOutput:
    """Routed MoE over x [B, S, D]. The global dispatch (the default, as
    in the reference) sorts all B*S*k assignments at once; the grouped
    one sorts each batch row's own and runs [B*E] buffer groups over the
    shared [E, D, F] weights. `full_capacity` makes the dispatch dropless
    (capacity = all tokens); otherwise each expert takes at most
    min(T, max(k, int(T*k*cf/E + 0.5))) assignments, T the tokens sorted
    together. `token_mask` [B, S] excludes masked tokens from dispatch,
    counts and the aux loss: their assignments take the sentinel expert
    id E, so the stable sort parks them after every real one. `backend`
    overrides `cfg.moe_backend` for this call. `logits` [B*S, E] fp32
    are the router's, computed by the caller (the mesh path's split
    router); `shared=False` leaves the shared experts to the caller.
    `partial`: a process group over which the expert FFN's outputs are
    partial sums (the mesh path's routed experts split over F): the
    tokens and combine weights enter them through f (their gradients
    summed over it) and the outputs are summed over it, as under expert
    parallelism."""
    kind = moe_backend(cfg, backend)
    fwd = _moe_forward_grouped if grouped else _moe_forward_global
    return fwd(p, cfg, x, capacity_factor, full_capacity, token_mask, kind, logits, shared,
               partial)


def _capacity(n: int, k: int, e: int, cf: float) -> int:
    return min(n, max(k, int(n * k * cf / e + 0.5)))


def _aux_and_counts(mo, probs, a_exp, live, n_tokens: int, token_mask, dp=None):
    """Switch-style load-balance loss and expert counts [E] int32 over the
    flat assignments `a_exp` ([n_tokens * k]); with `live` (the
    assignments' token mask) only live tokens count. Over `dp` shards the
    counts and token totals are summed, and the loss is the whole batch's
    (it is linear in each shard's sum of probs), its gradient this
    shard's own part."""
    e, k = mo.n_experts, mo.top_k
    probs = probs.reshape(-1, e)
    ones = torch.ones_like(a_exp, dtype=torch.int32) if live is None else live.to(torch.int32)
    counts = torch.zeros(e, dtype=torch.int32, device=probs.device).index_add_(0, a_exp, ones)
    if dp is not None:
        counts = all_reduce(counts, dp[0])
        if live is None:
            n, psum = float(n_tokens * dp[1]), probs.sum(0)
        else:
            tm = token_mask.reshape(-1)
            n = torch.clamp(all_reduce(tm.sum().float(), dp[0]), min=1.0)
            psum = (probs * tm[:, None]).sum(0)
        part = mo.router_aux_coef * e * torch.sum(counts.float() / (n * k) * (psum / n))
        return part + (all_reduce(part.detach(), dp[0]) - part.detach()), counts
    if live is None:
        frac_tokens = counts.float() / (n_tokens * k)
        frac_probs = probs.mean(0)
    else:
        tm = token_mask.reshape(-1)
        n_live = torch.clamp(tm.sum().float(), min=1.0)
        frac_tokens = counts.float() / (n_live * k)
        frac_probs = (probs * tm[:, None]).sum(0) / n_live
    return mo.router_aux_coef * e * torch.sum(frac_tokens * frac_probs), counts


def _bincount(x: torch.Tensor, n: int) -> torch.Tensor:
    """torch.bincount(x, minlength=n) for x < n, of a fixed length (a
    fake-tensor trace cannot size bincount's output)."""
    return torch.zeros(n, dtype=torch.int64, device=x.device).index_add_(
        0, x.long(), torch.ones_like(x, dtype=torch.int64))


def _moe_forward_global(p, cfg, x, capacity_factor, full_capacity, token_mask=None,
                        kind: str = "auto", logits=None, shared: bool = True,
                        partial=None) -> MoEOutput:
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    t = b * s
    dp = _dp()
    n_all = t if dp is None else t * dp[1]  # the tokens sorted together
    cf = capacity_factor if capacity_factor is not None else mo.capacity_factor
    cap = n_all if full_capacity else _capacity(n_all, k, e, cf)

    flat = x.reshape(t, d)
    probs, w, idx = route(p, mo, flat.float() @ p["router"] if logits is None else logits)
    idx, held = held_ids(mo, idx)
    probs = _held_probs(mo, probs)
    live = None if token_mask is None else token_mask.reshape(t).repeat_interleave(k)
    if held is not None:
        live = held.reshape(-1) if live is None else live & held.reshape(-1)
        if token_mask is None:  # the aux loss's live tokens
            token_mask = torch.ones(b, s, dtype=torch.bool, device=x.device)

    # flatten (token, expert) assignments and sort them by expert
    a_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    a_exp = idx.reshape(-1)
    a_key = a_exp if live is None else torch.where(live, a_exp, e)
    order = torch.argsort(a_key, stable=True)
    se, st, sw = a_key[order], a_tok[order], w.reshape(-1)[order]
    pos = torch.arange(t * k, device=x.device) - torch.searchsorted(se, se)
    rows = cap  # buffer rows per expert
    split_rows = False
    if dp is None:
        keep = (pos < cap) & (se < e)
    else:
        # the global sort puts the shards before this one first
        before = all_gather_stack(_bincount(a_key, e + 1), dp[0])[:dp[2]]
        gpos = pos + before.sum(0)[se]
        keep = (gpos < cap) & (se < e)
        # rows at their global places, the experts' rows split over DP, where
        # the [E, cap] buffers moved are no larger than the [E, t] ones each
        # shard would compute on alone (the dry-run's granite and jamba
        # train cells: cap > t, where moving them costs more than the rows)
        split_rows = cap <= t
        if split_rows:
            rows = -(-cap // dp[1]) * dp[1]
            pos = gpos
        else:
            rows = t  # a shard holds at most t assignments per expert
    ep = _experts(p, e)
    lo, n_local = (0, e) if ep is None else ep[:2]
    if ep is not None:  # buffers for this rank's experts only
        keep = keep & (se >= lo) & (se < lo + n_local)
    # the overflow row is dropped
    slot = torch.where(keep, (se - lo) * rows + pos, n_local * rows)

    part = ep[2] if ep is not None else partial
    if part is not None:  # each rank's experts give a part of these gradients
        flat, sw = copy_to_group(flat, part), copy_to_group(sw, part)
    # index_select, not x[idx]: its backward is one index_add, where fancy
    # indexing's sorts the indices first (a third of a train step's device time)
    buf = x.new_zeros(n_local * rows + 1, d).index_put((slot,), flat.index_select(0, st))
    h = buf[: n_local * rows].reshape(n_local, rows, d)
    if split_rows:  # each row filled on one shard: the sum is that shard's row
        h = ReduceScatter.apply(h, dp[0], dp[1], 1)
    o = expert_ffn(h, p["w_gate"], p["w_up"], p["w_down"], backend=kind, decode=(s == 1))
    if split_rows:  # every shard's combine reads every row (backward: reduce-scatter)
        o = GatherDim.apply(o, dp[0], dp[1], dp[2], 1, True)
    obuf = torch.cat([o.reshape(n_local * rows, d), o.new_zeros(1, d)])

    contrib = obuf.index_select(0, slot) * (sw * keep)[:, None].to(o.dtype)
    y = x.new_zeros(t, d).index_add(0, st, contrib).reshape(b, s, d)
    if part is not None:
        y = reduce_from_group(y, part)
    if mo.n_shared and shared:
        y = y + shared_ffn(p["shared"], x)
    aux, counts = _aux_and_counts(mo, probs, a_exp, live, t, token_mask, dp)
    return MoEOutput(y, aux, counts)


def _pad_experts(o: torch.Tensor, lo: int, e: int, dim: int) -> torch.Tensor:
    """Local experts' outputs placed among zeros for the other experts
    (along `dim`), so the combine reads every expert's buffer rows."""
    shape = list(o.shape)
    shape[dim] = lo
    head = o.new_zeros(shape)
    shape[dim] = e - lo - o.shape[dim]
    return torch.cat([head, o, o.new_zeros(shape)], dim)


def _moe_forward_grouped(p, cfg, x, capacity_factor, full_capacity=False,
                         token_mask=None, kind: str = "auto", logits=None,
                         shared: bool = True, partial=None) -> MoEOutput:
    """Per-row dispatch: [B, S, D] -> buffers [B, E, C, D] -> expert FFN
    -> combine, every sort row-local. The [B*E] buffer groups run over
    the one [E, D, F] weight tensor through group -> expert rows
    tile(arange(E), B), with no copy of the weights."""
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    cf = capacity_factor if capacity_factor is not None else mo.capacity_factor
    cap = s if full_capacity else _capacity(s, k, e, cf)

    if logits is None:
        logits = x.float() @ p["router"]
    probs, w, idx = route(p, mo, logits.reshape(b, s, -1))  # [B, S, k]
    idx, held = held_ids(mo, idx)
    probs = _held_probs(mo, probs)
    a_tok = torch.arange(s, device=x.device)[None, :, None].expand(b, s, k).reshape(b, s * k)
    a_exp = idx.reshape(b, s * k)
    live = None if token_mask is None else token_mask.repeat_interleave(k, dim=-1)
    if held is not None:
        live = held.reshape(b, s * k) if live is None else live & held.reshape(b, s * k)
        if token_mask is None:  # the aux loss's live tokens
            token_mask = torch.ones(b, s, dtype=torch.bool, device=x.device)
    a_key = a_exp if live is None else torch.where(live, a_exp, e)

    order = torch.argsort(a_key, dim=-1, stable=True)  # row-local sort
    se = torch.gather(a_key, -1, order)
    st = torch.gather(a_tok, -1, order)
    sw = torch.gather(w.reshape(b, s * k), -1, order)
    pos = torch.arange(s * k, device=x.device)[None, :] - torch.searchsorted(se, se)
    keep = (pos < cap) & (se < e)
    slot = torch.where(keep, se * cap + pos, e * cap)  # [B, S*k]

    rows = torch.arange(b, device=x.device)[:, None]
    ep = _experts(p, e)
    part = ep[2] if ep is not None else partial
    xs = x
    if part is not None:  # each rank's experts give a part of these gradients
        xs, sw = copy_to_group(x, part), copy_to_group(sw, part)
    xk = torch.gather(xs, 1, st[..., None].expand(-1, -1, d))  # [B, S*k, D]
    buf = x.new_zeros(b, e * cap + 1, d).index_put((rows, slot), xk)
    if ep is None:
        h = buf[:, : e * cap].reshape(b * e, cap, d)
        ge = torch.arange(e, dtype=torch.int32, device=x.device).repeat(b)
        o = expert_ffn(h, p["w_gate"], p["w_up"], p["w_down"], backend=kind, group_expert=ge)
    else:  # this rank's E/m experts of every row: [B*E/m] groups
        lo, n_local, _ = ep
        h = buf[:, : e * cap].reshape(b, e, cap, d)[:, lo:lo + n_local]
        ge = torch.arange(n_local, dtype=torch.int32, device=x.device).repeat(b)
        o = expert_ffn(h.reshape(b * n_local, cap, d), p["w_gate"], p["w_up"], p["w_down"],
                       backend=kind, group_expert=ge)
        o = _pad_experts(o.reshape(b, n_local, cap, d), lo, e, 1)

    obuf = torch.cat([o.reshape(b, e * cap, d), o.new_zeros(b, 1, d)], dim=1)
    contrib = torch.gather(obuf, 1, slot[..., None].expand(-1, -1, d))
    contrib = contrib * (sw * keep)[..., None].to(o.dtype)
    y = x.new_zeros(b * s, d).index_add(0, (st + rows * s).reshape(-1),
                                        contrib.reshape(-1, d)).reshape(b, s, d)
    if part is not None:
        y = reduce_from_group(y, part)
    if mo.n_shared and shared:
        y = y + shared_ffn(p["shared"], x)
    flat_live = None if live is None else live.reshape(-1)
    aux, counts = _aux_and_counts(mo, probs, a_exp.reshape(-1), flat_live, b * s, token_mask,
                                  _dp())
    return MoEOutput(y, aux, counts)


def moe_forward_mesh(tp, p, cfg, x: torch.Tensor, *, full_capacity: bool,
                     token_mask: torch.Tensor | None = None,
                     backend: str | None = None) -> MoEOutput:
    """The flat routed MoE on a mesh (`tp`, p's leaves `Local`), serving
    or training: the router split over D (partial logits summed over
    "model"), the global dispatch over the DP shards, and the routed
    experts as the rules place them: E over "model" runs this rank's E/m
    experts (the hinted expert-parallel dispatch, outputs summed over
    "model"), F over "model" gives partial sums (summed alike); the shared
    experts column- then row-parallel. The aux loss is the whole batch's,
    its gradient this DP shard's part (`_aux_and_counts`)."""
    from repro_torch.distributed import tensor_parallel as tpl

    refuse_on_mesh(cfg, "the flat MoE")
    b, s, d = x.shape
    logits = tpl.router_logits(tp, x.reshape(b * s, d), p["router"])
    ws = {key: tp.weight(p[key]) for key in ("w_gate", "w_up", "w_down")}
    split = ws["w_gate"][1]
    if split not in (None, 0, 2) or split != ws["w_up"][1]:
        raise ValueError(f"routed experts split as {p['w_gate'].axes}, {p['w_up'].axes}")
    with moe_sharding_hints(), shd.use_mesh(tp.mesh, tp.batch):
        out = moe_forward({key: w for key, (w, _, _) in ws.items()}, cfg, x,
                          full_capacity=full_capacity, token_mask=token_mask,
                          backend=backend, logits=logits, shared=False,
                          partial=tp.model if split == 2 else None)
    y = out.y
    if cfg.moe.n_shared:
        y = y + tpl.shared_ffn(tp, p["shared"], x)
    return MoEOutput(y, out.aux_loss, out.expert_counts)
