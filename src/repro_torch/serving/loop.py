"""Continuous-batching TriMoE serving loop (port of
repro/serving/loop.py:211, `ServingLoop` with its defaults).

  ServingLoop
    ├─ ZigzagBatcher       — request queue, slot allocation, group rotation
    ├─ PagedKVCache        — block pools + tables + radix prefix index
    └─ TriMoEServingEngine — paged decode / chunked prefill / migration

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
from repro_torch.models.model import check_supported, resolve_device
from repro_torch.obs import resolve_obs
from repro_torch.obs.metrics import RegistryStats, pct
from repro_torch.serving.batching import BucketTable, Request, ZigzagBatcher
from repro_torch.serving.engine import (
    TriMoEServingEngine,
    fill_tiers_from_params,
    init_tiered_for_model,
)
from repro_torch.serving.paged_kv import PagedKVCache
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
    """Multi-request continuous-batching loop over the TriMoE engine, in
    the reference's default configuration: paged KV with `block_size`-
    token blocks, radix prefix reuse and chunked piggyback prefill.

    batch_size decode slots are split into n_groups zigzag groups. Each
    iteration admits queued requests (claiming their longest cached
    prefix), runs at most one budgeted prefill chunk of up to
    `prefill_chunk_tokens` suffix tokens, decodes the active group, then
    applies the previous iteration's migration plans and draws new ones
    from the previous group's realized expert loads.

    Runs on the card unless `device="cpu"` is passed (then every kernel
    wrapper runs its plain PyTorch version). The kernel backends are the
    config's, resolved by the tensors' device. Later slices of the port
    add `spec_decode=True` and `kv_layout="slots"`; here they raise
    NotImplementedError.
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
        prefill_chunk_tokens: Optional[int] = None,
        spec_decode: bool = False,
        scheduler: Optional[SchedulerPolicy] = None,
        obs=None,  # Observability | ObsConfig | None (repro_torch.obs)
        device=None,
    ):
        assert cfg.moe is not None, "ServingLoop drives the TriMoE MoE path"
        if kv_layout != "paged":
            raise NotImplementedError("kv_layout='slots' is not ported yet")
        if spec_decode:
            raise NotImplementedError("speculative decode is not ported yet")
        check_supported(cfg)
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
        self.kv = PagedKVCache(
            cfg, batch_size, cache_len, block_size=block_size,
            n_blocks=kv_pool_blocks, prefix_cache=prefix_cache,
            sanitize=kv_sanitize, device=self.device,
        )
        if tiered is None:
            if sizes is None:
                sizes = tier_sizes(
                    cfg, reclaimed_kv_bytes=self.kv.reclaimed_bytes(cache_len)
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
        self.stats = LoopStats(self.obs.registry)
        self.completions: List[Request] = []
        self._t_admit: Dict[int, float] = {}
        self._t_submit: Dict[int, float] = {}
        self._t_last_tok: Dict[int, float] = {}
        self._slot_req: Dict[int, Request] = {}  # slot -> request
        self._prefill_tasks: List[_PrefillTask] = []  # FIFO piggyback queue
        self._pending_counts = None  # previous group's realized loads
        self._planned: list = []  # plans drawn but not yet applied
        self._steps_since_replan = 0  # policy.replan_every cadence

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        assert req.prompt_len + req.max_new_tokens - 1 <= self.kv.seq_len, (
            f"request {req.rid}: {req.prompt_len}+{req.max_new_tokens} tokens "
            f"overflow the cache (cache_len={self.kv.seq_len})"
        )
        self._t_submit[req.rid] = time.time()
        self.batcher.submit(req)

    def _free_slots(self, freed: List[int]) -> None:
        """Evict finished requests' KV: index their full (prompt +
        generated) blocks for future prefix hits, then drop refcounts."""
        for i in freed:
            r = self._slot_req.pop(i, None)
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
            freed, filled = self.batcher.admit()
            self._drain_completed()
            self._free_slots(freed)
            for i in filled:
                r = self.batcher.slots[i].request
                # prefix-match on admission: claim the longest cached
                # prefix; the uncached suffix streams in as chunk work
                past = self.kv.admit_slot(i, r.prompt)
                self._slot_req[i] = r
                self._t_admit[r.rid] = time.time()
                self.stats.admitted += 1
                self.batcher.slots[i].prefilling = True
                self._prefill_tasks.append(_PrefillTask(i, r, past))

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
                    firsts = torch.argmax(logits, -1).cpu().numpy()
                self.batcher.slots[t.slot].prefilling = False
                self.kv.commit_prompt(t.slot, t.req.prompt)
                self._record_first(t.req, int(firsts[row]))
            else:
                unfinished.append(t)
        # rows is a prefix of the task queue; rotate its survivors back
        self._prefill_tasks = self._prefill_tasks[len(rows):] + unfinished

    def _record_first(self, r: Request, tok: int) -> None:
        r.generated.append(tok)
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
        counts = self._pending_counts.cpu().numpy()
        self._pending_counts = None
        eng.observe(counts)
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
        with tr.span("step"):
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
            with tr.span("decode"):
                for row, i in enumerate(idxs):
                    if live[row]:
                        # on-demand block alloc at block boundaries,
                        # copy-on-write if the tail block is shared
                        self.kv.ensure_block(i, int(pos[row]))
                logits, counts = self.engine.step_slots_paged(
                    toks, pos, idxs, self.kv.table_rows(idxs), live=live
                )
                # zigzag overlap: the host applies + replans migrations
                # while this group's step runs on the device
                self._flush_replan()
                self._pending_counts = counts
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
