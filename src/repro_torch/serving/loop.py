"""Continuous-batching TriMoE serving loop (port of
repro/serving/loop.py:211, `ServingLoop`; `_free_slots` :441,
`_admit_inner` :468, `step_once` :670, `_spec_step` :744,
`_default_sizes` :888).

  ServingLoop
    ├─ ZigzagBatcher       — request queue, slot allocation, group rotation
    ├─ PagedKVCache        — block pools + tables + radix prefix index
    ├─ PromptLookupDrafter — speculative drafts (spec_decode=True)
    │  (or SlotKVCache     — contiguous ring-buffer rows, kv_layout="slots")
    └─ TriMoEServingEngine — decode / prefill / migration

Decoding is greedy. With the engine default cold_capacity_frac=1.0 and
fp32 params the generated tokens equal the reference ServingLoop's on
the same weights and tier state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import SchedulerPolicy, resolve_policy
from repro_torch.models.layers import Params
from repro_torch.models.model import check_decoder_only, resolve_device
from repro_torch.obs import resolve_obs
from repro_torch.obs.metrics import RegistryStats, pct
from repro_torch.obs.trace import NULL_SPAN, sync_span
from repro_torch.serving.batching import BucketTable, Request, ZigzagBatcher
from repro_torch.serving.engine import (
    TriMoEServingEngine,
    fill_tiers_from_params,
    init_tiered_for_model,
)
from repro_torch.serving.kv_cache import SlotKVCache
from repro_torch.serving.paged_kv import PagedKVCache, prefix_cacheable
from repro_torch.serving.spec_decode import DraftConfig, PromptLookupDrafter
from repro_torch.serving.tiered_moe import TierSizes, tier_sizes


class LoopStats(RegistryStats):
    """Registry-backed serving-loop stats (repro_torch.obs) under the
    `serving.*` prefix. Field access (`stats.admitted += 1`,
    `stats.ttft_s.append(...)`) is source-compatible with the old
    dataclass; `snapshot()` returns the backing registry's one flat
    dict (benchmarks derive their JSON from it).

    Accumulate-vs-reset contract: every metric — including `wall_s` —
    ACCUMULATES across `run()` calls on the same LoopStats. Call
    `reset()` between timed passes (chip_smoke.py does) to start a
    fresh measurement window without detaching from the shared
    registry; binding a fresh `LoopStats()` also works but leaves the
    engine/predictor metrics on the loop's original registry.
    """

    PREFIX = "serving"
    COUNTERS = {
        "admitted": ("requests", "requests admitted into decode slots"),
        "completed": ("requests", "requests fully generated"),
        "decode_steps": ("steps", "group steps that ran the engine"),
        "idle_steps": ("steps", "group rotations finding the group empty"),
        "prefill_chunks": ("calls", "budgeted piggyback chunk calls"),
        "generated_tokens": (
            "tokens", "sampled tokens (prefill firsts + decode)"),
        "util_samples": ("samples", "slot-utilization samples taken"),
        # --- speculative decode (serving/spec_decode.py)
        "spec_steps": ("steps", "decode steps that verified >= 1 draft"),
        "spec_drafted_tokens": (
            "tokens", "draft tokens proposed for verification"),
        "spec_accepted_tokens": (
            "tokens", "draft tokens accepted by the verify chunk"),
        # --- scheduler observability (SchedulerPolicy surface)
        "replans": ("passes", "plan_migrations passes drawn by this loop"),
        "migrations": ("moves", "expert moves those passes emitted"),
        "thrash_events": (
            "events", "tier flip-flops within policy.thrash_window"),
    }
    GAUGES = {
        "wall_s": ("s", "accumulated run() wall time (see reset())"),
        "util_sum": ("", "summed slot-utilization samples"),
        "predictor_accuracy": ("", "EMA tier-prediction accuracy so far"),
    }
    HISTS = {
        "latencies_s": ("s", "per-request admit -> complete latency"),
        # per-request time-to-first-token (submit -> first sampled token)
        "ttft_s": ("s", "time-to-first-token (submit -> first token)"),
        # inter-token latency: gap between a request's consecutive tokens
        "itl_s": ("s", "inter-token latency between consecutive tokens"),
        "plan_s": ("s", "host-side migration-planning latency"),
    }

    def __init__(self, registry=None):
        super().__init__(registry)
        for name, fn, unit, desc in (
            ("serving.tokens_per_s", lambda: self.tokens_per_s, "tok/s",
             "generated_tokens / wall_s"),
            ("serving.mean_utilization", lambda: self.mean_utilization, "",
             "mean decode-slot utilization"),
            ("serving.mean_latency_s", lambda: self.mean_latency_s, "s",
             "mean request latency"),
            ("serving.migrations_per_replan",
             lambda: self.migrations_per_replan, "",
             "expert moves per replan pass"),
            ("serving.spec_acceptance_rate",
             lambda: self.spec_acceptance_rate, "",
             "accepted / proposed draft tokens"),
        ):
            self.registry.derived(name, fn, unit=unit, desc=desc,
                                  source="LoopStats")

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-9)

    @property
    def migrations_per_replan(self) -> float:
        return self.migrations / max(self.replans, 1)

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the verify chunk accepted;
        exactly 0.0 before any drafting (no division by zero)."""
        return self.spec_accepted_tokens / max(self.spec_drafted_tokens, 1)

    @property
    def plan_p50_s(self) -> float:
        return self._pct(self.plan_s, 50)

    @property
    def plan_p95_s(self) -> float:
        return self._pct(self.plan_s, 95)

    @property
    def mean_utilization(self) -> float:
        return self.util_sum / max(self.util_samples, 1)

    @property
    def mean_latency_s(self) -> float:
        return float(np.mean(self.latencies_s)) if self.latencies_s else 0.0

    # robust percentile (repro.obs.pct): empty -> 0.0, single sample ->
    # itself, no numpy warnings — kept as a staticmethod for callers
    # that used LoopStats._pct directly
    _pct = staticmethod(pct)

    @property
    def ttft_p50_s(self) -> float:
        return self._pct(self.ttft_s, 50)

    @property
    def ttft_p95_s(self) -> float:
        return self._pct(self.ttft_s, 95)

    @property
    def itl_p50_s(self) -> float:
        return self._pct(self.itl_s, 50)

    @property
    def itl_p95_s(self) -> float:
        return self._pct(self.itl_s, 95)

    def summary(self) -> str:
        return (
            f"{self.completed}/{self.admitted} requests, "
            f"{self.generated_tokens} tokens in {self.wall_s:.2f}s "
            f"({self.tokens_per_s:.1f} tok/s), "
            f"util={self.mean_utilization:.2f}, "
            f"mean_latency={self.mean_latency_s * 1e3:.0f}ms, "
            f"ttft_p95={self.ttft_p95_s * 1e3:.0f}ms "
            f"itl_p95={self.itl_p95_s * 1e3:.0f}ms, "
            f"decode_steps={self.decode_steps} idle_steps={self.idle_steps} "
            f"prefill_chunks={self.prefill_chunks}, "
            f"spec_acc={self.spec_acceptance_rate:.2f} "
            f"({self.spec_accepted_tokens}/{self.spec_drafted_tokens}), "
            f"replans={self.replans} "
            f"migrations={self.migrations} "
            f"({self.migrations_per_replan:.1f}/replan) "
            f"thrash={self.thrash_events} "
            f"plan_p95={self.plan_p95_s * 1e3:.1f}ms "
            f"pred_acc={self.predictor_accuracy:.2f}"
        )


@dataclasses.dataclass
class _PrefillTask:
    """One admitted request's in-flight piggyback prefill: `done` tokens
    of the prompt are already in the cache (radix prefix hit + chunks
    landed so far); the rest streams in budgeted chunks."""

    slot: int
    req: Request
    done: int


class ServingLoop:
    """Multi-request continuous-batching loop over the TriMoE engine.

    batch_size decode slots are split into n_groups zigzag groups. Each
    iteration admits queued requests, prefills them, decodes the active
    group, then applies the previous iteration's migration plans and
    draws new ones from the previous group's realized expert loads.

    The defaults are the reference's: paged KV with `block_size`-token
    blocks and radix prefix reuse (admission claims each prompt's longest
    cached prefix), and chunked piggyback prefill (`chunked_prefill=True`:
    the uncached suffix streams in chunks of at most
    `prefill_chunk_tokens` tokens, one chunk call per iteration beside
    the decode step). With `chunked_prefill=False`, or under
    `kv_layout="slots"` (the contiguous SlotKVCache, no prefix reuse),
    admission prefills each request's whole uncached suffix at once:
    same-bucket admissions padded to the bucket width in one masked
    prefill call, or, with `bucket_table=None`, exact-length rows.

    Speculative decode (`spec_decode=True`, serving/spec_decode.py):
    each decode step drafts up to `spec_config.k` tokens per live slot
    (prompt lookup: the radix prefix index first, the slot's own suffix
    n-grams second; no draft model, no RNG) and verifies the chunks
    [sampled token, drafts...] of the group in ONE
    `engine.verify_slots_paged` call through the same paged kernels. The
    greedy accept-prefix rule commits every draft that matches the
    verify argmax plus one bonus token; rejected tails roll back through
    `PagedKVCache.truncate`. At fp32 the token streams equal plain
    serving's (a chunk of 1 is the decode step); it needs the paged
    layout and an attention-only arch.

    Runs on the card unless `device="cpu"` is passed (then every kernel
    wrapper runs its plain PyTorch version). The kernel backends are the
    config's, resolved by the tensors' device.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        tiered: Optional[Params] = None,
        *,
        batch_size: int = 8,
        n_groups: int = 1,
        cache_len: int = 64,
        sizes: Optional[TierSizes] = None,
        cold_capacity_frac: float = 1.0,
        rng_seed: int = 1,
        bucket_table: "BucketTable | None | str" = "auto",
        prefill_rows: Optional[int] = None,
        max_admit_wait: int = 4,
        kv_layout: str = "paged",
        block_size: int = 4,
        kv_pool_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        kv_sanitize: Optional[bool] = None,  # None -> $REPRO_KV_SANITIZE
        chunked_prefill: bool = True,
        prefill_chunk_tokens: Optional[int] = None,
        spec_decode: bool = False,
        spec_config: Optional[DraftConfig] = None,
        scheduler: Optional[SchedulerPolicy] = None,
        obs=None,  # Observability | ObsConfig | None (repro_torch.obs)
        device=None,
    ):
        assert cfg.moe is not None, "ServingLoop drives the TriMoE MoE path"
        assert kv_layout in ("paged", "slots"), kv_layout
        check_decoder_only(cfg, "the serving loop")
        self.device = resolve_device(device)
        if params["embed"]["table"].device != self.device:
            raise ValueError(
                f"params live on {params['embed']['table'].device}, the loop "
                f"serves on {self.device}"
            )
        self.policy = resolve_policy(cfg, scheduler, caller="ServingLoop")
        cfg = dataclasses.replace(cfg, scheduler=self.policy)
        self.obs = resolve_obs(cfg, obs, caller="ServingLoop")
        self._tr = self.obs.tracer
        self.cfg = cfg
        self.paged = kv_layout == "paged"
        # chunked piggyback needs a token-position-addressable cache for
        # every mixer: a chunk boundary cannot thread recurrent state
        self.chunked = chunked_prefill and self.paged and prefix_cacheable(cfg)
        if self.paged:
            self.kv = PagedKVCache(
                cfg, batch_size, cache_len, block_size=block_size,
                n_blocks=kv_pool_blocks, prefix_cache=prefix_cache,
                sanitize=kv_sanitize, device=self.device,
            )
        else:
            self.kv = SlotKVCache(cfg, batch_size, cache_len, device=self.device)
        if tiered is None:
            if sizes is None:  # as the reference: the paged pool's savings buy hot slots
                sizes = (
                    tier_sizes(cfg, reclaimed_kv_bytes=self.kv.reclaimed_bytes(cache_len))
                    if self.paged else _default_sizes(cfg)
                )
            gen = torch.Generator(device=self.device).manual_seed(rng_seed)
            tiered = init_tiered_for_model(gen, cfg, sizes)
            tiered = fill_tiers_from_params(params, tiered, cfg)
        if bucket_table == "auto":
            bucket_table = BucketTable.powers_of_two(cache_len)
        self.bucket_table = bucket_table
        self.batcher = ZigzagBatcher(
            batch_size, n_groups, bucket_table=bucket_table,
            max_admit_wait=max_admit_wait,
        )
        self.engine = TriMoEServingEngine(
            cfg, params, self.kv, tiered, sizes=sizes,
            cold_capacity_frac=cold_capacity_frac,
            prefill_rows=prefill_rows or min(batch_size, 4),
            scheduler=self.policy, obs=self.obs,
        )
        # budgeted suffix tokens per piggyback chunk call: the bound on
        # how long any single prefill call can stall decode
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = 32
        assert prefill_chunk_tokens >= 1
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # verify and rollback go through the paged block pools, so spec
        # decode has the gate of chunked prefill
        self.spec = bool(spec_decode)
        if self.spec:
            assert self.paged and prefix_cacheable(cfg), (
                "spec_decode requires kv_layout='paged' and an "
                "attention-only arch (chunk-of-k verification and "
                "rollback go through the paged block pools)"
            )
            self.drafter = PromptLookupDrafter(spec_config, radix=self.kv.radix)
        else:
            self.drafter = None
        self.stats = LoopStats(self.obs.registry)
        self.completions: List[Request] = []
        self._t_admit: Dict[int, float] = {}
        self._t_submit: Dict[int, float] = {}
        self._t_last_tok: Dict[int, float] = {}
        self._slot_req: Dict[int, Request] = {}  # paged: slot -> request
        self._prefill_tasks: List[_PrefillTask] = []  # FIFO piggyback queue
        self._pending_counts = None  # previous group's realized loads
        self._pending_tokens = 0  # the live tokens those loads routed
        self._picks_per_token = (cfg.moe.top_k * sum(
            cfg.uses_moe_layer(i) for i in range(cfg.n_layers)) if cfg.moe else 0)
        # decode top-k assignments observed so far: to the experts held
        # here (the counts' sum), and routed (top_k x MoE layers x live
        # tokens); each `decode` span carries both totals
        self.held_picks = 0
        self.routed_picks = 0
        self._planned: list = []  # plans drawn but not yet applied
        self._steps_since_replan = 0  # policy.replan_every cadence
        self._step_no = 0  # step_once calls: the `step` span's index

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        assert req.prompt_len + req.max_new_tokens - 1 <= self.kv.seq_len, (
            f"request {req.rid}: {req.prompt_len}+{req.max_new_tokens} tokens "
            f"overflow the cache (cache_len={self.kv.seq_len})"
        )
        self._t_submit[req.rid] = time.time()
        self.batcher.submit(req)

    def _free_slots(self, freed: List[int]) -> None:
        """Evict finished requests' KV: paged slots index their full
        (prompt + generated) blocks for future prefix hits before the
        refcounts drop; contiguous slots zero their rows."""
        if not freed:
            return
        if not self.paged:
            self.kv.free(freed)
            return
        for i in freed:
            r = self._slot_req.pop(i, None)
            if self.drafter is not None:
                self.drafter.free_slot(i)
            # the FINAL sampled token was never fed back through decode,
            # so its K/V does not exist: index prompt + generated[:-1]
            toks = (
                None if r is None
                else np.concatenate([np.asarray(r.prompt, np.int32),
                                     np.asarray(r.generated[:-1], np.int32)])
            )
            self.kv.free_slot(i, tokens=toks)

    def _admit(self) -> None:
        with self._tr.span("admit"):
            self._admit_inner()

    def _admit_inner(self) -> None:
        freed, filled = self.batcher.admit()
        self._drain_completed()
        self._free_slots(freed)
        past_len: Dict[int, int] = {}
        for i in filled:
            r = self.batcher.slots[i].request
            if self.paged:
                # prefix-match on admission: claim the longest cached
                # prefix, allocate fresh blocks for the uncached rest
                past_len[i] = self.kv.admit_slot(i, r.prompt)
                self._slot_req[i] = r
                if self.drafter is not None:
                    self.drafter.begin_slot(i, r.prompt)
            else:
                self.kv.claim(i)
            self._t_admit[r.rid] = time.time()
            self.stats.admitted += 1
        if not filled:
            return
        if self.chunked:
            # piggyback admission: the uncached suffix streams in as
            # budgeted chunk work, one chunk call per iteration
            for i in filled:
                r = self.batcher.slots[i].request
                self.batcher.slots[i].prefilling = True
                self._prefill_tasks.append(_PrefillTask(i, r, past_len.get(i, 0)))
            return
        # whole-suffix admission: prefill writes the slots' cache (rows or
        # blocks) and its per-row logits sample the first token
        if not self.paged and self.bucket_table is None:
            for i in filled:  # exact-length path
                r = self.batcher.slots[i].request
                logits = self.engine.prefill_slots(r.prompt[None, :], [i])
                with sync_span(self._tr, "first_token"):
                    first = int(torch.argmax(logits[0], -1))
                self._record_first(r, first, i)
            return
        # same-bucket admissions share one padded masked prefill; under
        # the paged layout rows are keyed by their UNCACHED suffix length
        groups: Dict[int, List[int]] = {}
        for i in filled:
            r = self.batcher.slots[i].request
            n_new = r.prompt_len - past_len.get(i, 0)
            key = n_new if self.bucket_table is None else self.bucket_table.bucket_of(n_new)
            groups.setdefault(key, []).append(i)
        for width, slots in sorted(groups.items()):
            prompts = np.zeros((len(slots), width), np.int32)
            lengths = np.zeros((len(slots),), np.int32)
            pasts = np.zeros((len(slots),), np.int32)
            for row, i in enumerate(slots):
                r = self.batcher.slots[i].request
                pasts[row] = past_len.get(i, 0)
                suffix = r.prompt[pasts[row]:]
                prompts[row, : len(suffix)] = suffix
                lengths[row] = len(suffix)
            if self.paged:
                logits = self.engine.prefill_slots_paged(prompts, slots, lengths, pasts)
                for i in slots:
                    # index the freshly computed prompt blocks so later
                    # (and queued) admissions can share them
                    self.kv.commit_prompt(i, self.batcher.slots[i].request.prompt)
            else:
                logits = self.engine.prefill_slots(prompts, slots, lengths=lengths)
            with sync_span(self._tr, "first_tokens"):
                firsts = torch.argmax(logits, -1).cpu().numpy()
            for row, i in enumerate(slots):
                self._record_first(self.batcher.slots[i].request, int(firsts[row]), i)

    def _prefill_step(self) -> None:
        """Run at most ONE budgeted chunk call of pending piggyback
        prefill work (round-robin over unfinished tasks); a task whose
        last chunk lands samples its first token, radix-commits the
        prompt and rejoins decode."""
        if not self._prefill_tasks:
            return
        with self._tr.span("prefill_chunk"):
            self._prefill_chunk()

    def _prefill_chunk(self) -> None:
        rows: List[tuple] = []  # (task, chunk size)
        left = self.prefill_chunk_tokens
        for t in self._prefill_tasks:
            if left <= 0 or len(rows) >= self.engine.prefill_rows:
                break
            # FIFO followers join only if their whole chunk fits the
            # leftover budget: co-scheduling must not shrink chunks
            n = min(t.req.prompt_len - t.done, self.prefill_chunk_tokens)
            if rows and n > left:
                break
            rows.append((t, n))
            left -= n
        width = max(n for _, n in rows)
        if self.bucket_table is not None:
            width = self.bucket_table.bucket_of(width)
        prompts = np.zeros((len(rows), width), np.int32)
        lengths = np.zeros((len(rows),), np.int32)
        pasts = np.zeros((len(rows),), np.int32)
        slots = []
        for row, (t, n) in enumerate(rows):
            prompts[row, :n] = t.req.prompt[t.done:t.done + n]
            lengths[row] = n
            pasts[row] = t.done
            slots.append(t.slot)
        logits = self.engine.prefill_slots_paged(prompts, slots, lengths, pasts)
        self.stats.prefill_chunks += 1
        firsts = None
        unfinished = []
        for row, (t, n) in enumerate(rows):
            t.done += n
            if t.done == t.req.prompt_len:
                if firsts is None:
                    with sync_span(self._tr, "first_tokens"):
                        firsts = torch.argmax(logits, -1).cpu().numpy()
                self.batcher.slots[t.slot].prefilling = False
                self.kv.commit_prompt(t.slot, t.req.prompt)
                self._record_first(t.req, int(firsts[row]), t.slot)
            else:
                unfinished.append(t)
        # rows is a prefix of the task queue; rotate its survivors back
        self._prefill_tasks = self._prefill_tasks[len(rows):] + unfinished

    def _record_first(self, r: Request, tok: int, slot: int) -> None:
        r.generated.append(tok)
        if self.drafter is not None:
            self.drafter.extend(slot, [tok])
        self.stats.generated_tokens += 1
        now = time.time()
        t0 = self._t_submit.get(r.rid, self._t_admit.get(r.rid))
        if t0 is not None:
            self.stats.ttft_s.append(now - t0)
        self._t_last_tok[r.rid] = now

    def _drain_completed(self) -> None:
        while len(self.completions) < len(self.batcher.completed):
            r = self.batcher.completed[len(self.completions)]
            self.completions.append(r)
            self.stats.completed += 1
            t0 = self._t_admit.get(r.rid)
            if t0 is not None:
                self.stats.latencies_s.append(time.time() - t0)
            for d in (self._t_admit, self._t_submit, self._t_last_tok):
                d.pop(r.rid, None)

    # ------------------------------------------------------------- drive
    def _work_remaining(self) -> bool:
        if self.batcher.queue or self._prefill_tasks:
            return True
        return any(
            s.request is not None and not s.request.done for s in self.batcher.slots
        )

    def _flush_replan(self) -> None:
        """Apply the plans drawn last iteration (overlapping the step now
        queued on the device), observe the previous group's loads, and
        every `policy.replan_every` steps draw the next plans."""
        eng = self.engine
        if self._planned:
            eng.apply_planned(self._planned)
            self._planned = []
        if self._pending_counts is None:
            return
        with sync_span(self._tr, "expert_counts"):
            counts = self._pending_counts.cpu().numpy()
        self._pending_counts = None
        eng.observe(counts)
        self.held_picks += int(counts.sum())
        self.routed_picks += self._picks_per_token * self._pending_tokens
        self._steps_since_replan += 1
        if self._steps_since_replan < self.policy.replan_every:
            return
        self._steps_since_replan = 0
        st, es = self.stats, eng.stats
        thrash_before = es.thrash_events
        with self._tr.span("replan", cat="scheduler"):
            self._planned = eng.plan_migrations()
        st.replans += 1
        st.migrations += sum(
            int((plan[:, 0] >= 0).sum()) for _, plan in self._planned
        )
        st.thrash_events += es.thrash_events - thrash_before
        st.plan_s.append(es.plan_latency_s[-1])
        st.predictor_accuracy = eng.predictor.stats.accuracy

    def step_once(self) -> None:
        """One scheduling iteration: admit, one piggyback prefill chunk,
        one zigzag-group decode step, then the replan flush."""
        tr = self._tr
        self._step_no += 1
        with tr.span("step", step=self._step_no) if tr.enabled else NULL_SPAN:
            self._admit()
            self._prefill_step()
            gb = self.batcher.next_group()
            self.stats.util_sum += self.batcher.utilization
            self.stats.util_samples += 1
            if tr.enabled:
                tr.counter("loop/slots", {
                    "utilization": self.batcher.utilization,
                    "queued": len(self.batcher.queue),
                    "prefill_tasks": len(self._prefill_tasks),
                })
            if gb is None:
                # the active group is idle: use its slot for migrations
                self.stats.idle_steps += 1
                self._flush_replan()
                return
            _, idxs, toks, pos, live = gb
            decode = (tr.span("decode", rows=len(idxs), live=int(np.count_nonzero(live)))
                      if tr.enabled else NULL_SPAN)
            if self.spec:
                with decode:
                    self._spec_step(idxs, toks, pos, live)
                return
            with decode:
                if self.paged:
                    for row, i in enumerate(idxs):
                        if live[row]:
                            # on-demand block alloc at block boundaries,
                            # copy-on-write if the tail block is shared
                            self.kv.ensure_block(i, int(pos[row]))
                    logits, counts = self.engine.step_slots_paged(
                        toks, pos, idxs, self.kv.table_rows(idxs), live=live
                    )
                else:
                    logits, counts = self.engine.step_slots(toks, pos, idxs, live=live)
                # zigzag overlap: the host applies + replans migrations
                # while this group's step runs on the device
                self._flush_replan()
                if tr.enabled:
                    decode.args.update(held_picks=self.held_picks,
                                       routed_picks=self.routed_picks)
                self._pending_counts = counts
                self._pending_tokens = int(np.count_nonzero(live))
                with sync_span(tr, "next_tokens"):
                    nxt = torch.argmax(logits, -1).cpu().numpy()
            live_idx = [i for i, alive in zip(idxs, live) if alive]
            self.batcher.record(live_idx, nxt[live])
            self.stats.decode_steps += 1
            self.stats.generated_tokens += len(live_idx)
            now = time.time()
            for i in live_idx:
                rid = self.batcher.slots[i].request.rid
                prev = self._t_last_tok.get(rid)
                if prev is not None:
                    self.stats.itl_s.append(now - prev)
                self._t_last_tok[rid] = now

    def _spec_step(self, idxs, toks, pos, live) -> None:
        """Speculative decode of one zigzag group: draft per slot, verify
        every chunk in ONE chunk-of-k engine call, greedy accept-prefix,
        roll back rejected tails.

        A live row's chunk is [this step's input token, draft_1..]: the
        argmax at position i is what sequential greedy decode would sample
        after draft i, so comparing it with draft i + 1 and committing the
        first mismatch position's argmax as the bonus token reproduces the
        sequential stream token for token (a row with no drafts is the
        chunk of 1, the plain decode step). Accepted positions keep the
        K/V the verify scattered; rejected tails roll back through
        `PagedKVCache.truncate`."""
        st, tr = self.stats, self._tr
        drafts: List[List[int]] = [[] for _ in idxs]
        with tr.span("spec.draft", cat="spec"):
            for row, i in enumerate(idxs):
                if not live[row]:
                    continue
                r = self.batcher.slots[i].request
                # the commit adds at most `remaining` tokens (accepted
                # drafts + bonus), and every chunk position must fit the
                # slot's block table
                cap = min(r.max_new_tokens - len(r.generated) - 1,
                          self.kv.seq_len - 1 - int(pos[row]))
                if cap > 0:
                    drafts[row] = self.drafter.draft(i, cap)
        n_drafted = sum(len(d) for d in drafts)
        width = 1 + max(len(d) for d in drafts)
        chunk = np.zeros((len(idxs), width), np.int32)
        lens = np.zeros((len(idxs),), np.int32)
        for row, i in enumerate(idxs):
            if not live[row]:
                continue
            row_toks = [int(toks[row, 0])] + drafts[row]
            chunk[row, : len(row_toks)] = row_toks
            lens[row] = len(row_toks)
            for p in range(int(pos[row]), int(pos[row]) + len(row_toks)):
                # on-demand alloc + copy-on-write for every chunk position
                self.kv.ensure_block(i, p)
        with tr.span("spec.verify", cat="spec"):
            logits, counts = self.engine.verify_slots_paged(chunk, idxs, lens, pos, live=live)
            # zigzag overlap, exactly as the plain decode step
            self._flush_replan()
            self._pending_counts = counts
            self._pending_tokens = int(lens.sum())
            with sync_span(tr, "next_tokens"):
                nxt = torch.argmax(logits, -1).cpu().numpy()  # [W, Kp]
        st.decode_steps += 1
        if n_drafted:
            st.spec_steps += 1
            st.spec_drafted_tokens += n_drafted
        now = time.time()
        for row, i in enumerate(idxs):
            if not live[row]:
                continue
            r = self.batcher.slots[i].request
            d = drafts[row]
            a = 0
            while a < len(d) and int(nxt[row, a]) == d[a]:
                a += 1
            commit = d[:a] + [int(nxt[row, a])]
            st.spec_accepted_tokens += a
            # multi-token commit by hand (ZigzagBatcher.record takes one
            # token), then the cache rolls back to the committed length:
            # the bonus token's K/V does not exist yet, as after a step
            r.generated.extend(commit)
            self.batcher.slots[i].pos += len(commit)
            self.kv.truncate(i, int(pos[row]) + len(commit))
            self.drafter.extend(i, commit)
            st.generated_tokens += len(commit)
            prev = self._t_last_tok.get(r.rid)
            if prev is not None:
                # the step's gap spread over its committed tokens, so ITL
                # percentiles stay comparable with plain decode
                gap = (now - prev) / len(commit)
                for _ in commit:
                    st.itl_s.append(gap)
            self._t_last_tok[r.rid] = now

    def finish(self) -> None:
        """Settle deferred scheduling work and recycle the final wave of
        completions, leaving the loop reusable."""
        self._flush_replan()
        if self._planned:
            self.engine.apply_planned(self._planned)
            self._planned = []
        self._free_slots(self.batcher.recycle())
        self._drain_completed()

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive until every submitted request completes (or max_steps
        iterations elapse). Returns completed requests in completion
        order; wall_s accumulates across run() calls."""
        t_start = time.time()
        steps = 0
        while self._work_remaining():
            if max_steps is not None and steps >= max_steps:
                break
            steps += 1
            self.step_once()
        self.finish()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.wall_s += time.time() - t_start
        return self.completions


def _default_sizes(cfg: ModelConfig) -> TierSizes:
    """The contiguous layout's tier split, as the reference's: ~25% hot,
    ~30% warm, the rest cold."""
    e = cfg.moe.n_experts
    n_hot = max(1, e // 4)
    n_warm = max(1, int(0.3 * e))
    return TierSizes(n_hot, n_warm, e - n_hot - n_warm)
