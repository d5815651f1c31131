"""What one run recorded, as the metric readers of `bench/metrics/` see it,
and the small reductions several readers share."""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

import roofline
from spec import Dims


@dataclasses.dataclass
class MoECall:
    """One MoE layer's call in the window: decode step or prefill call,
    its per-expert assignment counts, whether the profiler was on."""
    decode: bool
    counts: np.ndarray
    profiled: bool


@dataclasses.dataclass
class Record:
    dims: Dims
    setup_s: float
    window_s: float  # the measured window, host clock
    tokens: int  # generated tokens delivered in the window
    ttft_s: List[float]  # due time to first token, requests first answered in the window
    itl_s: List[float]  # gaps between consecutive tokens, both in the window
    step_s: List[float]  # step_once durations in the window, the profiled slice left out
    loop: Dict[str, float]  # window deltas of the loop's and KV cache's counters
    plan_s: List[float]  # the planner's latencies in the window
    moe_calls: List[MoECall] = dataclasses.field(default_factory=list)
    decode_ctx: List[int] = dataclasses.field(default_factory=list)  # profiled decode rows
    prefill_rows: List[Tuple[int, int]] = dataclasses.field(default_factory=list)  # (past, n)
    trace: dict = dataclasses.field(default_factory=dict)  # devtrace.reduce_events

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.trace.get("kernel_s", {}).items() if rx.search(name))

    def expert_bound_s(self, decode: bool) -> float:
        """Summed roofline bounds of the profiled MoE calls of one kind
        (each call: its tiers' expert FFNs together)."""
        total = 0.0
        for c in self.moe_calls:
            if c.profiled and c.decode == decode:
                total += roofline.expert_call_bound_s(
                    self.dims, int((c.counts > 0).sum()), int(c.counts.sum()))
        return total

    def roofline_pct(self, pattern: str, decode: bool) -> Optional[float]:
        t = self.kernel_seconds(pattern)
        bound = self.expert_bound_s(decode)
        return 100.0 * bound / t if t > 0 and bound > 0 else None

    def mfu_pct(self) -> Optional[float]:
        w = self.trace.get("window_s")
        if not w:
            return None
        flops = roofline.window_flops(self.dims, self.decode_ctx, self.prefill_rows)
        return 100.0 * flops / (w * roofline.PEAK_FLOPS[self.dims.dtype])


def pct(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile over all values (linear interpolation), None
    for no values."""
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None
