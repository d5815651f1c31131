"""Replay a saved RequestTrace through a live ServingLoop (port of
repro/serving/replay.py).

The trace (core/traces.py) pins the workload — arrival iteration,
prompt token ids, decode lengths — so every replay of the same file
drives the loop through the identical admission schedule on any
machine: skewed, phase-shifting token populations routed through the
real model produce the shifting expert popularity that gives the tier
scheduler genuine work.

Arrivals are exact: request i is submitted at the first loop iteration
>= `trace.arrival_step[i]`, interleaved with `loop.step_once()` calls,
so bursts land mid-decode rather than being queued up front. Wall time
is accumulated into `loop.stats.wall_s` by `replay_requests` (the loop's own
`run()` is bypassed — `step_once`/`finish` keep the deferred replan
state live across iterations instead of settling it every call).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.traces import RequestTrace
from repro_torch.serving.batching import Request


def requests_from_trace(trace: RequestTrace, rid_base: int = 0) -> List[Request]:
    """Materialize Request objects (prompt arrays + decode budgets)."""
    return [
        Request(
            rid=rid_base + i,
            prompt=np.asarray(trace.prompt(i), np.int32),
            max_new_tokens=int(trace.new_tokens[i]),
        )
        for i in range(len(trace))
    ]


@dataclass
class ReplayResult:
    completions: list
    iterations: int

    def tokens(self) -> List[List[int]]:
        """Generated token ids in rid order — the replay's identity
        fingerprint (dynamic vs static scheduling must agree at fp32)."""
        return [
            list(map(int, r.generated))
            for r in sorted(self.completions, key=lambda r: r.rid)
        ]


def replay_requests(
    loop,
    trace: RequestTrace,
    *,
    rid_base: int = 0,
    max_iterations: Optional[int] = None,
) -> ReplayResult:
    """Drive `loop` through the trace's exact arrival schedule.

    Returns only this replay's completions (the loop may hold earlier
    passes' history). Raises if the replay fails to drain within
    `max_iterations` (default: a generous bound from the trace length)
    — a stuck loop should fail loudly, not spin.
    """
    reqs = requests_from_trace(trace, rid_base=rid_base)
    if max_iterations is None:
        horizon = int(trace.arrival_step.max()) if len(trace) else 0
        budget = int(trace.prompt_lens.sum() + trace.new_tokens.sum())
        max_iterations = horizon + 64 * (budget + 1)
    done_before = len(loop.completions)
    t_start = time.time()
    i = 0
    it = 0
    while True:
        while i < len(reqs) and int(trace.arrival_step[i]) <= it:
            loop.submit(reqs[i])
            i += 1
        if i >= len(reqs) and not loop._work_remaining():
            break
        if it >= max_iterations:
            raise RuntimeError(
                f"replay did not drain within {max_iterations} iterations "
                f"({i}/{len(reqs)} submitted, "
                f"{len(loop.completions) - done_before} completed)"
            )
        loop.step_once()
        it += 1
    loop.finish()
    if loop.device.type == "cuda":  # the wall time covers the queued device work
        torch.cuda.synchronize(loop.device)
    loop.stats.wall_s += time.time() - t_start
    return ReplayResult(completions=loop.completions[done_before:], iterations=it)
