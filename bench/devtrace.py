"""Reduction of the traced slice's torch.profiler events: device time by
kernel, the busy union, and idle gaps named by what the host was doing.

Host ranges are the benchmark's own `torch.profiler.record_function`
ranges, named "bench.<span>" (`harness.SPANS`), around its calls into
the loop and the engine; "bench.slice" brackets the whole traced slice.
Device events are every activity the profiler reports on the card
(kernels, copies, sets), except its mirrors of the host ranges.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

PREFIX = "bench."


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, namespace tag and
    argument list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(")[0].strip()[:width]


def reduce_events(events) -> dict:
    """window_s, busy_s, kernel_s {name: seconds}, device_ops and idle_gaps
    (top 10 [name, seconds] each) of the events of one traced slice."""
    dev: List[Tuple[float, float, str]] = []
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.name.startswith(PREFIX):
            if not _is_device(e):
                spans.append((t0, t1, e.name[len(PREFIX):]))
        elif _is_device(e) and t1 > t0:
            dev.append((t0, t1, e.name))
    window = [s for s in spans if s[2] == "slice"]
    if not window or not dev:
        return {}
    w0, w1 = window[0][0], window[0][1]
    spans = sorted(s for s in spans if s[2] != "slice")
    kernel_s: Dict[str, float] = defaultdict(float)
    for t0, t1, name in dev:
        kernel_s[name] += (t1 - t0) * 1e-6
    # busy: the union of device intervals inside the window
    merged: List[List[float]] = []
    for t0, t1, _ in sorted(dev):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle[_innermost(spans, starts, (a + b) / 2)] += (b - a) * 1e-6
    by_op: Dict[str, float] = defaultdict(float)
    for name, s in kernel_s.items():
        by_op[short_name(name)] += s
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6, "kernel_s": dict(kernel_s),
            "device_ops": top(by_op), "idle_gaps": top(idle)}


def _innermost(spans, starts, t: float) -> str:
    """The shortest host range that holds time `t` (ranges nest: a step
    holds admit, prefill and decode); "between_steps" outside every one."""
    best, best_len = "between_steps", float("inf")
    i = bisect.bisect_right(starts, t)
    for s0, s1, name in reversed(spans[max(0, i - 16):i]):
        if s0 <= t < s1 and s1 - s0 < best_len:
            best, best_len = name, s1 - s0
    return best
