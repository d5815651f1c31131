"""TriMoE serving engine (port of repro/serving/engine.py:
`init_tiered_for_model` :73, `fill_tiers_from_params` :93,
`strip_expert_weights` :130, the constructor :176, `cache` :341, `step`
:368, `step_slots` :378, `prefill_slots` :401, `step_slots_paged` :470,
`prefill_slots_paged` :512, `verify_slots_paged` :586 with
`verify_compiles` :668, the width sets :312-318, and the planner
`observe` / `plan_migrations` / `apply_planned` / `replan` :724-904).

Two KV layouts: the paged block pools (`PagedKVCache`: `step_slots_paged`,
`prefill_slots_paged`) and the contiguous slot rows (`SlotKVCache`:
`step_slots`, `prefill_slots`, and the full-batch `step`). Per decode
step the model runs attention + the three-tier MoE and returns
per-expert token counts; the host feeds them to the EMA
predictor (`observe`), draws cost-ranked migration plans scored with the
reference's TPU-domain cost model (kept verbatim so the plans equal the
reference's), and `apply_planned` swaps expert weights between the tier
buffers in place. The serving loop defers the apply until the next step
is queued on the device.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import ExpertShape, TPUDomains
from repro_torch.core.policy import SchedulerPolicy, resolve_policy
from repro_torch.core.predictor import EMALoadPredictor
from repro_torch.core.tiers import COLD, HOT, WARM
from repro_torch.kernels.paged_attention import active_block_width
from repro_torch.models.layers import Params
from repro_torch.models.model import (
    decode_step,
    decode_step_paged,
    decode_verify,
    index_tree,
    layer_signature,
    prefill,
    prefill_paged,
    stack_plan,
)
from repro_torch.obs import resolve_obs
from repro_torch.obs.metrics import RegistryStats
from repro_torch.obs.trace import sync_span
from repro_torch.serving.kv_cache import SlotKVCache, gather_slots, scatter_slots
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.tiered_moe import (
    TierSizes,
    apply_migrations,
    init_tiered_state,
    tier_occupancy,
    tier_sizes,
)


def moe_slot_names(cfg: ModelConfig):
    """Which scan slots (and unrolled layers) carry MoE."""
    unrolled, n_groups, period = stack_plan(cfg)
    slots = [f"slot{j}" for j, sig in enumerate(period) if sig[1] == "moe"]
    layers = [f"layer{li}" for li in unrolled if layer_signature(cfg, li)[1] == "moe"]
    return layers, slots, n_groups


def init_tiered_for_model(gen: torch.Generator, cfg: ModelConfig,
                          sizes: Optional[TierSizes] = None, mesh=None,
                          pad_cold_to: Optional[int] = None) -> Params:
    """Tier states mirroring the params stacking (scan groups x slots).
    For a `mesh` the sizes default to its world size and the cold pool is
    padded to a multiple of its "data" axis (the reference pads to 16, the
    production mesh's), so `tiered_pspec` can home the cold experts over
    it; without one, to 16; `pad_cold_to` overrides either."""
    if cfg.moe is None:
        return None
    pad = 16
    if mesh is not None:
        from repro_torch.distributed.sharding import mesh_shape

        dims = mesh_shape(mesh)
        pad = dims.get("data", 1)
        sizes = sizes or tier_sizes(cfg, n_chips=int(np.prod(list(dims.values()))))
    pad = pad_cold_to or pad
    sizes = sizes or tier_sizes(cfg)
    layers, slots, n_groups = moe_slot_names(cfg)
    out: Params = {name: init_tiered_state(gen, cfg, sizes, pad) for name in layers}
    if slots:
        out["stack"] = {s: init_tiered_state(gen, cfg, sizes, pad, lead=(n_groups,))
                        for s in slots}
    return out


def _fill_one(state, w_gate, w_up, w_down) -> None:
    """Copy flat expert weights into one layer's tier buffers (in place),
    by its routing tables; the down matrix is stored transposed."""
    tier = state["expert_tier"].cpu().numpy()
    slot = state["expert_slot"].cpu().numpy()
    for e in range(len(tier)):
        dst = state[("hot", "warm", "cold")[tier[e]]][int(slot[e])]
        dst[0] = w_gate[e]
        dst[1] = w_up[e]
        dst[2] = w_down[e].T


def fill_tiers_from_params(params: Params, tiered: Params, cfg: ModelConfig) -> Params:
    """Copy the flat MoE expert weights into the tier buffers according
    to the routing tables (in place), so tiered serving computes the
    model's own experts. Padding slots keep their init."""
    layers, slots, n_groups = moe_slot_names(cfg)
    for name in layers:
        ffn = params[name]["ffn"]
        _fill_one(tiered[name], ffn["w_gate"], ffn["w_up"], ffn["w_down"])
    for s in slots:
        for g in range(n_groups):
            ffn = index_tree(params["stack"][s]["ffn"], g)
            _fill_one(index_tree(tiered["stack"][s], g),
                      ffn["w_gate"], ffn["w_up"], ffn["w_down"])
    return tiered


def strip_expert_weights(params: Params, cfg: ModelConfig) -> Params:
    """Serving params without the flat expert weights (they live in the
    tier buffers); router and shared experts stay."""
    layers, slots, _ = moe_slot_names(cfg)

    def strip(ffn):
        return {k: v for k, v in ffn.items() if k not in ("w_gate", "w_up", "w_down")}

    out = dict(params)
    for name in layers:
        out[name] = {**params[name], "ffn": strip(params[name]["ffn"])}
    if slots:
        stack = dict(params["stack"])
        for s in slots:
            stack[s] = {**stack[s], "ffn": strip(stack[s]["ffn"])}
        out["stack"] = stack
    return out


class EngineStats(RegistryStats):
    """Registry-backed engine counters under the `engine.*` prefix."""

    PREFIX = "engine"
    COUNTERS = {
        "steps": ("steps", "decode steps dispatched"),
        "prefills": ("rows", "prefill rows computed"),
        "prefill_tokens": ("tokens", "real prompt tokens prefilled"),
        "migrations": ("moves", "expert moves emitted by planning"),
        "plans": ("plans", "layers that emitted at least one move"),
        "replans": ("passes", "plan_migrations passes over all layers"),
        "thrash_events": (
            "events", "tier flip-flops within policy.thrash_window"),
    }
    HISTS = {
        "plan_latency_s": ("s", "host-side plan_migrations latency"),
    }


class TriMoEServingEngine:
    """Serving engine: decode and prefill through the tiered MoE runtime
    against the paged block pools or the contiguous slot rows, plus the
    migration planner. `cache` is a PagedKVCache, a SlotKVCache, or a raw
    contiguous cache tree (wrapped with every slot allocated, for
    full-batch stepping). `cold_capacity_frac=1.0` keeps the tiered
    dispatch exactly dropless."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        cache,
        tiered: Params,
        sizes: Optional[TierSizes] = None,
        cold_capacity_frac: float = 1.0,
        prefill_rows: int = 4,
        scheduler: Optional[SchedulerPolicy] = None,
        obs=None,
    ):
        assert cfg.moe is not None, "TriMoE engine requires a routed-MoE arch"
        self.cfg = cfg
        self.obs = resolve_obs(cfg, obs, caller="TriMoEServingEngine")
        self._tr = self.obs.tracer
        self.params = strip_expert_weights(params, cfg)
        self.device = params["embed"]["table"].device
        self.kv = (
            cache if isinstance(cache, (SlotKVCache, PagedKVCache))
            else SlotKVCache.from_cache(cache)
        )
        self.tiered = tiered
        self.sizes = sizes or tier_sizes(cfg)
        self.policy = resolve_policy(cfg, scheduler, caller="TriMoEServingEngine")
        self.th = self.policy.thresholds
        self.cold_capacity_frac = cold_capacity_frac
        n_moe = sum(cfg.uses_moe_layer(i) for i in range(cfg.n_layers))
        self.predictor = EMALoadPredictor(
            n_moe, cfg.moe.n_experts, alpha=self.policy.ema_alpha,
            thresholds=self.th, hysteresis=self.policy.hysteresis,
            registry=self.obs.registry,
        )
        self.domains = TPUDomains()
        self.shape = ExpertShape(cfg.d_model, cfg.moe.d_expert)
        self.stats = EngineStats(self.obs.registry)
        # thrash bookkeeping: (layer, expert) -> (replan idx, src tier)
        self._move_history: Dict[tuple, tuple] = {}
        self._unapplied: Optional[list] = None
        self.prefill_rows = prefill_rows
        self.decode_table_widths = set()  # distinct sliced widths (pow2)
        self.prefill_table_widths = set()  # paged prefill's sliced widths
        self.verify_widths = set()  # spec verify's pow2 chunk widths
        self.verify_table_widths = set()  # ... and its sliced table widths
        self._verify_shapes = set()  # (chunk width, table width) pairs
        self._layer_keys = self._flatten_layer_keys()
        # host mirror of each layer's (expert_tier, expert_slot), seeded
        # lazily from the device; plan_migrations keeps it in lockstep
        self._host_layout: Dict[int, tuple] = {}

    @property
    def cache(self):
        """The contiguous cache tree (a SlotKVCache's; the paged layout
        exposes kv.pools)."""
        assert isinstance(self.kv, SlotKVCache), (
            "raw-cache access is a SlotKVCache affordance; the paged "
            "layout exposes kv.pools"
        )
        return self.kv.cache

    def _flatten_layer_keys(self) -> List[tuple]:
        """Ordered (kind, name, group) keys, one per MoE layer."""
        layers, slots, n_groups = moe_slot_names(self.cfg)
        keys = [("layer", n, 0) for n in layers]
        for g in range(n_groups):
            for s in slots:
                keys.append(("stack", s, g))
        return keys

    def _get_state(self, key) -> Params:
        kind, name, g = key
        if kind == "layer":
            return self.tiered[name]
        return index_tree(self.tiered["stack"][name], g)

    def _dev(self, a, what: str, dtype=torch.int32) -> torch.Tensor:
        """Host array `a` on the device: a pageable upload, which blocks
        the host until the stream drains (a `sync` span, `what`)."""
        with sync_span(self._tr, what):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ----------------------------------------------------------- stepping
    def step(self, tokens, pos: int):
        """Full-batch decode of every cache row at one position, then a
        synchronous replan."""
        logits, _, counts = decode_step(
            self.params, self.cfg, self._dev(tokens, "tokens"), self.cache,
            self._dev(pos, "positions"), tiered=self.tiered,
            cold_capacity_frac=self.cold_capacity_frac,
        )
        self.stats.steps += 1
        with sync_span(self._tr, "expert_counts"):
            counts = counts.cpu().numpy()
        self.replan(counts)
        return logits

    def step_slots(self, tokens, pos, slot_indices, live=None):
        """Decode only the cache rows in `slot_indices` (the active zigzag
        group): gather the rows, decode (ring buffers written at pos % S),
        scatter them back. tokens [W, 1]; pos [W] per-slot positions; live
        [W] bool (dead rows are left out of MoE dispatch and counts).
        Returns (logits [W, V], expert_counts [L, E]) without replanning."""
        if live is None:
            live = np.ones((len(slot_indices),), bool)
        sub = self.kv.gather(slot_indices)
        logits, sub, counts = decode_step(
            self.params, self.cfg, self._dev(tokens, "tokens"), sub, self._dev(pos, "positions"),
            tiered=self.tiered, cold_capacity_frac=self.cold_capacity_frac,
            token_mask=self._dev(live, "live", torch.bool),
        )
        self.kv.scatter(sub, slot_indices)
        self.stats.steps += 1
        return logits, counts

    def prefill_slots(self, prompts, slot_indices, lengths=None):
        """Prefill newly admitted requests into their cache rows through
        the tiered MoE runtime; returns each row's logits [W, V], which
        sample its first token.

        Without `lengths` every row is exactly S real tokens (the
        exact-length path). With `lengths` [W], rows are right-padded to
        a shared bucket width and run through the masked prefill, padded
        with dummy (all-pad) rows to `prefill_rows` rows a call (more
        rows run in several calls); the dummy rows are dropped before the
        scatter, so none overwrites slot 0."""
        assert self.kv.seq_len is not None, (
            "prefill_slots needs a SlotKVCache built with an explicit seq_len"
        )
        if lengths is None:
            prompts = np.asarray(prompts, np.int32)
            logits, sub = prefill(self.params, self.cfg, self._dev(prompts, "tokens"),
                                  cache_len=self.kv.seq_len, tiered=self.tiered,
                                  cold_capacity_frac=self.cold_capacity_frac)
            self.kv.scatter(sub, slot_indices)
            self.stats.prefills += prompts.shape[0]
            self.stats.prefill_tokens += int(prompts.shape[0] * prompts.shape[1])
            return logits

        prompts = np.asarray(prompts, np.int32)
        lengths = np.asarray(lengths, np.int32)
        n, width = prompts.shape
        assert len(slot_indices) == n and lengths.shape == (n,)
        assert np.all(lengths <= width) and np.all(lengths > 0)
        r = self.prefill_rows
        out = []
        for c0 in range(0, n, r):
            nr = min(r, n - c0)
            toks = np.zeros((r, width), np.int32)
            lens = np.zeros((r,), np.int32)  # dummy rows: all-pad mask
            toks[:nr] = prompts[c0:c0 + nr]
            lens[:nr] = lengths[c0:c0 + nr]
            token_mask = np.arange(width)[None, :] < lens[:, None]
            logits, sub = prefill(self.params, self.cfg, self._dev(toks, "tokens"),
                                  cache_len=self.kv.seq_len, tiered=self.tiered,
                                  cold_capacity_frac=self.cold_capacity_frac,
                                  token_mask=self._dev(token_mask, "token_mask", torch.bool))
            if nr < r:  # drop the dummy rows before scattering
                sub = gather_slots(sub, list(range(nr)))
            self.kv.scatter(sub, list(slot_indices[c0:c0 + nr]))
            out.append(logits[:nr])
            self.stats.prefills += nr
            self.stats.prefill_tokens += int(lens.sum())
        return out[0] if len(out) == 1 else torch.cat(out)

    def step_slots_paged(self, tokens, pos, slot_indices, tables, live=None):
        """Paged decode of the active zigzag group: recurrent state rows
        gather and scatter by slot index (reference :279-285), K/V reads
        and writes go through the block pools by each row's table
        ([W, nb] int32), SLICED to the pow2-bucketed active width first.
        Dead rows write to the trash block. Returns (logits [W, V],
        expert_counts [L, E]) without replanning."""
        live = (
            np.ones((len(slot_indices),), bool) if live is None
            else np.asarray(live, bool)
        )
        pos = np.asarray(pos, np.int64)
        tables = np.array(tables, np.int32, copy=True)
        tables[~live] = self.kv.trash
        if self.kv.sanitizer is not None:
            lb = np.clip(pos // self.kv.block_size, 0, tables.shape[1] - 1)
            self.kv.sanitizer.check_scatter_targets(
                tables[np.arange(len(pos)), lb], live
            )
        mx = int(pos[live].max()) if live.any() else 0
        width = active_block_width(mx, self.kv.block_size, max(1, self.kv.blocks_per_slot))
        self.decode_table_widths.add(width)
        tables = np.ascontiguousarray(tables[:, :width])
        # the group's recurrent state rows move as the contiguous layout's do
        sub = gather_slots(self.kv.slot_state, slot_indices)
        logits, _, sub, counts = decode_step_paged(
            self.params, self.cfg, self._dev(tokens, "tokens"), self.kv.pools, sub,
            self._dev(tables, "tables"), self._dev(pos, "positions"), tiered=self.tiered,
            cold_capacity_frac=self.cold_capacity_frac,
            token_mask=self._dev(live, "live", torch.bool),
        )
        scatter_slots(self.kv.slot_state, sub, slot_indices)
        self.stats.steps += 1
        return logits, counts

    def prefill_slots_paged(self, suffixes, slot_indices, lengths, past_len):
        """Chunked suffix-only masked prefill into paged slots.

        suffixes [W, S] int32 each row's uncached suffix chunk, right-
        padded; lengths [W] real lengths; past_len [W] tokens cached
        before the chunk. Tables are sliced to the pow2 active width of
        the furthest row end, rows padded to `prefill_rows` (dummy rows:
        all-trash tables, zero mask). The real rows' recurrent states are
        scattered into their slots; the dummy rows' never are (reference
        :571-579). Returns last-real-token logits [W, V]."""
        suffixes = np.asarray(suffixes, np.int32)
        lengths = np.asarray(lengths, np.int32)
        past_len = np.asarray(past_len, np.int32)
        n, width = suffixes.shape
        assert len(slot_indices) == n
        assert np.all(lengths > 0) and np.all(lengths <= width)
        r = self.prefill_rows
        out = []
        for c0 in range(0, n, r):
            nr = min(r, n - c0)
            end = int((past_len[c0:c0 + nr] + lengths[c0:c0 + nr]).max())
            tw = active_block_width(
                end - 1, self.kv.block_size, max(1, self.kv.blocks_per_slot)
            )
            self.prefill_table_widths.add(tw)
            toks = np.zeros((r, width), np.int32)
            lens = np.zeros((r,), np.int32)  # dummy rows: all-pad mask
            past = np.zeros((r,), np.int32)
            tables = np.full((r, tw), self.kv.trash, np.int32)
            toks[:nr] = suffixes[c0:c0 + nr]
            lens[:nr] = lengths[c0:c0 + nr]
            past[:nr] = past_len[c0:c0 + nr]
            tables[:nr] = self.kv.table_rows(slot_indices[c0:c0 + nr])[:, :tw]
            self._check_chunk_writes(tables, past, lens, np.arange(r) < nr)
            token_mask = np.arange(width)[None, :] < lens[:, None]
            logits, _, row_states = prefill_paged(
                self.params, self.cfg, self._dev(toks, "tokens"), self.kv.pools,
                self._dev(tables, "tables"), self._dev(past, "positions"),
                self._dev(token_mask, "token_mask", torch.bool),
                tiered=self.tiered, cold_capacity_frac=self.cold_capacity_frac,
            )
            if nr < r:  # drop the dummy rows before scattering state
                row_states = gather_slots(row_states, list(range(nr)))
            scatter_slots(self.kv.slot_state, row_states, list(slot_indices[c0:c0 + nr]))
            out.append(logits[:nr])
            self.stats.prefills += nr
            self.stats.prefill_tokens += int(lens.sum())
        return out[0] if len(out) == 1 else torch.cat(out)

    def _check_chunk_writes(self, tables, past, lens, real) -> None:
        """Sanitizer hook of a chunk call: each real row writes the span
        [past, past + len) of its table, whose blocks must be private; a
        pad or dead row's table must be all trash."""
        if self.kv.sanitizer is None:
            return
        bs = self.kv.block_size
        bids, mask = [], []
        for j in range(len(tables)):
            lo, hi = int(past[j]) // bs, -(-int(past[j] + lens[j]) // bs)
            span = tables[j, lo:hi] if real[j] else tables[j]
            bids.extend(span.tolist())
            mask.extend([bool(real[j])] * len(span))
        self.kv.sanitizer.check_scatter_targets(bids, mask)

    def verify_slots_paged(self, chunks, slot_indices, lengths, past_len, live=None):
        """Speculative chunk-of-k verification of the active zigzag group
        against the paged pools.

        chunks [W, K] int32 each row's [sampled token, draft_1..] chunk,
        right-padded; lengths [W] real chunk tokens (a row with no drafts
        verifies a chunk of 1: exactly its decode step); past_len [W] the
        rows' committed lengths before the chunk. The caller has
        `ensure_block`'d every chunk position; rejected positions are
        rolled back afterwards (PagedKVCache.truncate). The chunk pads to
        a pow2 width and the tables slice to the pow2 active width, as
        decode and prefill do; dead rows get zero length and past and
        all-trash tables, so all their writes land in the trash block.

        Returns (logits [W, Kp, V], expert_counts [n_layers, E]): position
        i's logits condition on chunk tokens 0..i and the cached prefix."""
        chunks = np.asarray(chunks, np.int32)
        lengths = np.asarray(lengths, np.int32)
        past_len = np.asarray(past_len, np.int32)
        n, width = chunks.shape
        assert len(slot_indices) == n
        live = np.ones((n,), bool) if live is None else np.asarray(live, bool)
        assert np.all(lengths[live] > 0) and np.all(lengths <= width)
        kw = 1
        while kw < width:
            kw *= 2
        toks = np.zeros((n, kw), np.int32)
        toks[:, :width] = chunks
        lens = np.where(live, lengths, 0).astype(np.int32)
        past = np.where(live, past_len, 0).astype(np.int32)
        end = int((past + lens).max()) if live.any() else 1
        tw = active_block_width(end - 1, self.kv.block_size, max(1, self.kv.blocks_per_slot))
        self.verify_widths.add(kw)
        self.verify_table_widths.add(tw)
        self._verify_shapes.add((kw, tw))
        tables = np.full((n, tw), self.kv.trash, np.int32)
        tables[live] = self.kv.table_rows(slot_indices)[:, :tw][live]
        self._check_chunk_writes(tables, past, lens, live)
        token_mask = np.arange(kw)[None, :] < lens[:, None]
        # no slot state to scatter: `decode_verify` raises for a recurrent
        # arch (a chunk would restart its layers from the init state, not
        # the rows'), as the loop's spec gate refuses one
        logits, _, counts = decode_verify(
            self.params, self.cfg, self._dev(toks, "tokens"), self.kv.pools,
            self._dev(tables, "tables"), self._dev(past, "positions"),
            self._dev(token_mask, "token_mask", torch.bool), tiered=self.tiered,
            cold_capacity_frac=self.cold_capacity_frac,
        )
        self.stats.steps += 1
        return logits, counts

    @property
    def verify_compiles(self) -> int:
        """Distinct (pow2 chunk width, table width) shapes the verify ran
        at. The port has no jit, so this is the reference's own fallback
        count (`len(_verify_shapes)`), the number of compiles the JAX
        engine would make for the same traffic."""
        return len(self._verify_shapes)

    # ---------------------------------------------------------- migration
    def _tier_costs(self, loads: np.ndarray) -> np.ndarray:
        """[3, *loads.shape] seconds for every expert in every tier under
        the TPU-domain cost model (loads clamped to >= 1 token)."""
        loads = np.maximum(np.asarray(loads, np.float64), 1.0)
        costs = np.empty((3,) + loads.shape)
        costs[HOT] = self.domains.v_replicated(self.shape, loads)
        costs[WARM] = self.domains.v_striped(self.shape, loads)
        costs[COLD] = self.domains.v_localized(self.shape, loads)
        return costs

    @property
    def swap_cost_s(self) -> float:
        """Cost of one expert migration: both experts' weight stacks
        cross the resharding collective — the breakeven bar each
        candidate move is charged against."""
        hw = self.domains.hw
        return 2.0 * self.shape.weight_bytes / (hw.ici_link_bw * hw.ici_links)

    def observe(self, counts) -> None:
        """Feed realized per-layer expert loads to the EMA predictor.
        As in the reference (engine.py:724), row li of `counts` (one row
        per model layer) feeds MoE layer key li: where a dense layer comes
        first (deepseek's layer 0), each MoE layer's predictor sees the
        loads of the layer before it. Kept so the port plans as the
        reference does."""
        counts = np.asarray(counts)
        for li in range(len(self._layer_keys)):
            self.predictor.update(li, counts[li])

    def plan_migrations(self) -> list:
        """Draw migration plans from the predictor's hysteresis tier
        decisions WITHOUT applying them: [(layer_key, plan [plan_rows, 5])]
        for `apply_planned`. Sizing, bottleneck-first ordering and thrash
        accounting are the reference's (engine.py:732)."""
        assert self._unapplied is None, (
            "plan_migrations called with unapplied plans pending; call "
            "apply_planned first"
        )
        t0 = time.perf_counter()
        policy = self.policy
        self.stats.replans += 1
        r_idx = self.stats.replans
        if self._tr.enabled:
            occ = tier_occupancy(self.predictor.decided, self.predictor.ema)
            self._tr.counter(
                "tier/experts",
                {k: v for k, v in occ.items() if k.endswith("_experts")},
                cat="tier",
            )
            self._tr.counter(
                "tier/predicted_load",
                {k: v for k, v in occ.items() if k.endswith("_load")},
                cat="tier",
            )
        plans: list = []
        if policy.freeze:
            self.stats.plan_latency_s.append(time.perf_counter() - t0)
            return plans
        swap_cost = self.swap_cost_s
        costs_all = (
            self._tier_costs(self.predictor.ema)
            if policy.cost_mode == "tpu" else None
        )
        e_idx = np.arange(self.predictor.ema.shape[1])
        for li, key in enumerate(self._layer_keys):
            decided = self.predictor.decided[li]
            if li not in self._host_layout:
                state = self._get_state(key)
                with sync_span(self._tr, "tier_layout"):
                    tier = state["expert_tier"].cpu().numpy().copy()
                with sync_span(self._tr, "tier_layout"):
                    slot = state["expert_slot"].cpu().numpy().copy()
                self._host_layout[li] = (tier, slot)
            cur_tier, cur_slot = self._host_layout[li]
            moves = np.nonzero(decided != cur_tier)[0]
            if len(moves) == 0:
                continue
            ema = self.predictor.ema[li]
            if policy.cost_mode == "tpu":
                cur_cost = costs_all[cur_tier, li, e_idx]
                delta = cur_cost - costs_all[decided, li, e_idx]
                tier_time = np.bincount(cur_tier, weights=cur_cost, minlength=3)
            else:  # "loads": pure EMA-mass ranking, no breakeven gate
                delta = ema.astype(np.float64)
                tier_time = np.bincount(cur_tier, weights=ema, minlength=3)
            if (
                policy.plan_size is None
                and policy.plan_min == 0
                and policy.cost_mode == "tpu"
                and not (delta[moves] * policy.amortize_steps > swap_cost).any()
            ):
                continue  # nothing clears breakeven
            benefit = {int(e): float(delta[e]) for e in moves}
            bottleneck = int(np.argmax(tier_time))
            order = sorted(
                (int(e) for e in moves),
                key=lambda e: (0 if cur_tier[e] == bottleneck else 1, -benefit[e]),
            )
            if policy.plan_size is not None:
                chosen = order[: policy.plan_size]
            else:
                chosen = [
                    e for e in order
                    if policy.cost_mode != "tpu"
                    or benefit[e] * policy.amortize_steps > swap_cost
                ][: policy.plan_max]
                if len(chosen) < policy.plan_min:
                    backfill = [e for e in order if e not in chosen]
                    chosen += backfill[: policy.plan_min - len(chosen)]
            if not chosen:
                continue
            plan = np.full((policy.plan_rows, 5), -1, np.int32)
            emitted = 0
            for e in chosen:
                dst_tier = int(decided[e])
                # victim: lowest-EMA expert currently in the target tier
                in_dst = np.nonzero(cur_tier == dst_tier)[0]
                if len(in_dst) == 0:
                    continue
                victim = in_dst[np.argmin(ema[in_dst])]
                e_tier, e_slot = int(cur_tier[e]), int(cur_slot[e])
                v_slot = int(cur_slot[victim])
                plan[emitted] = (e, e_tier, e_slot, dst_tier, v_slot)
                emitted += 1
                cur_tier[victim], cur_slot[victim] = e_tier, e_slot
                cur_tier[e], cur_slot[e] = dst_tier, v_slot
                self.stats.migrations += 1
                prev = self._move_history.get((li, e))
                if (
                    prev is not None
                    and prev[1] == dst_tier
                    and r_idx - prev[0] <= policy.thrash_window
                ):
                    self.stats.thrash_events += 1
                    if self._tr.enabled:
                        self._tr.instant(
                            "thrash", cat="tier", layer=li, expert=int(e),
                            back_to=dst_tier,
                        )
                self._move_history[(li, e)] = (r_idx, e_tier)
            if emitted == 0:
                continue
            plans.append((key, plan))
            self.stats.plans += 1
        if plans:
            self._unapplied = plans
        self.stats.plan_latency_s.append(time.perf_counter() - t0)
        return plans

    def apply_planned(self, plans: list) -> None:
        """Swap expert weights between tier buffers, in place, for plans
        from `plan_migrations`."""
        if not plans:
            self._unapplied = None
            return
        tr = self._tr
        with tr.span("migrate", cat="scheduler"):
            for key, plan in plans:
                kind, name, g = key
                if tr.enabled:
                    tr.instant(
                        "tier_migration", cat="tier",
                        layer=f"{kind}:{name}:g{g}",
                        moves=int((plan[:, 0] >= 0).sum()),
                    )
                apply_migrations(self._get_state(key), plan)
        self._unapplied = None

    def replan(self, counts) -> None:
        """Synchronous path: observe + plan + apply in one call (`step`)."""
        self.observe(counts)
        self.apply_planned(self.plan_migrations())
