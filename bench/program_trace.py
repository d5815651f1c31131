"""The program's own spans, as the per-layer readers of `bench/metrics/`
see them: the events of the tracer `repro_torch` installs process-wide
when a traced run builds its loop (`repro_torch.obs.trace`), and the
`trimoe.<span>` ranges that tracer opens on the profiler's timeline
during the traced slice.

Program spans (host clock): a run's window is the `run_seconds` before the
end of its last `step` span; spans carrying `profiled` (open while the
profiler recorded) are the traced slice's and are left out.

Profiler ranges (device trace): `reduce_program_ranges` lays the
`trimoe.` ranges beside the slice's device activity. Each stretch of the
slice in which the card is idle goes to the innermost range open on the
host then, and each kernel, copy or set to the innermost range open when
the host launched it (the launch is the CUDA API call sharing the
activity's correlation id). The ranges are function-scope records, so the
profiler shows no device-side copy of them.

Neither source exists in a program that does not emit them: every
function here then returns None or an empty result and raises nothing.
"""
from __future__ import annotations

import bisect
import gc
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from devtrace import _is_device

RANGE = "trimoe."
MOE = ("moe", "moe.route", "moe.tier", "moe.combine")

# the slice's events and their reduction, computed once for every reader
# (and printed whole by tools/program_split.py)
LAST: dict = {}


# ------------------------------------------------------- program spans
def program_events() -> Optional[List[dict]]:
    """The installed tracer's events, or None where the program installs
    none (or has no such slot)."""
    from repro_torch.obs import trace

    active = getattr(trace, "active_tracer", None)
    tr = active() if active is not None else None
    return None if tr is None else tr.events


def _spans(events: List[dict], name: str) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e["name"] == name]


def window_spans(rec, name: str) -> List[dict]:
    """`name` spans of the run's window, the traced slice's left out."""
    events = program_events()
    if not events:
        return []
    steps = _spans(events, "step")
    if not steps:
        return []
    end = max(e["ts"] + e["dur"] for e in steps)
    start = end - rec.window_s * 1e6 - 1e3  # 1 ms: the window's first step starts at t0
    return [e for e in _spans(events, name)
            if e["ts"] >= start and not e.get("args", {}).get("profiled")]


def per_span_ms(rec, outer: str, inner: Tuple[str, ...]) -> Optional[List[float]]:
    """For each `outer` span of the window, the host milliseconds of the
    `inner` spans it holds (same thread), summed; None where the program
    emits no `inner` span at all."""
    events = program_events()
    if not events or not any(e.get("ph") == "X" and e["name"] in inner for e in events):
        return None
    outers = sorted(window_spans(rec, outer), key=lambda e: e["ts"])
    if not outers:
        return None
    starts = [e["ts"] for e in outers]
    sums = [0.0] * len(outers)
    for e in events:
        if e.get("ph") != "X" or e["name"] not in inner:
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0:
            o = outers[i]
            if e["tid"] == o["tid"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]:
                sums[i] += e["dur"] * 1e-3
    return sums


def p50(values: Optional[List[float]]) -> Optional[float]:
    return float(np.median(values)) if values else None


# ---------------------------------------------------- profiler ranges
def _profile_events():
    """The events of the run's traced slice: the torch.profiler session
    whose events hold the benchmark's `bench.slice` range."""
    import torch

    for obj in gc.get_objects():
        if issubclass(type(obj), torch.profiler.profile) and obj.profiler is not None:
            try:
                events = obj.events()
            except (AssertionError, RuntimeError):
                continue
            if events and any(e.name == "bench.slice" for e in events):
                return events
    return None


def _segments(ranges: List[Tuple[float, float, str]]) -> List[Tuple[float, float, tuple]]:
    """The host's time cut where a range opens or closes: (t0, t1, the
    names of the ranges open over it, outermost first); time outside
    every range is left out. Ranges nest (each is one thread's)."""
    out: List[Tuple[float, float, tuple]] = []
    stack: List[Tuple[float, str]] = []  # (end, name)
    t = None

    def emit(upto: float) -> None:
        nonlocal t
        if stack and t is not None and upto > t:
            out.append((t, upto, tuple(n for _, n in stack)))
        t = upto if t is None else max(t, upto)

    for t0, t1, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= t0:
            emit(stack[-1][0])
            stack.pop()
        emit(t0)
        stack.append((min(t1, stack[-1][0]) if stack else t1, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return out


def _at(segments, starts, t: float) -> tuple:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][0] <= t < segments[i][1]:
        return segments[i][2]
    return ()


def reduce_program_ranges(events) -> dict:
    """Over the `bench.slice` window: `window_s`; `idle_s` {innermost
    range: idle seconds of the card} ("outside" where no range is open);
    `idle_path_s`, the same by the whole nest ("step/decode/moe/...");
    `idle_in_moe_s`, the idle seconds under a `moe` range or one of its
    children; `device_s` {innermost range at launch: device seconds of the
    activity launched there} ("unattributed" where no launch was seen);
    `migrate_device_s`, that under `migrate` ranges; `decode_steps`, the
    `decode` ranges. Empty where the slice holds no `trimoe.` range or no
    device activity."""
    ranges: List[Tuple[float, float, str]] = []
    launches: Dict[int, float] = {}
    dev: List[Tuple[float, float, int]] = []
    window = None
    for e in events:
        t0, t1, name = float(e.time_range.start), float(e.time_range.end), e.name
        if _is_device(e):
            if (not name.startswith((RANGE, "bench."))
                    and not getattr(e, "is_user_annotation", False) and t1 > t0):
                dev.append((t0, t1, e.id))
        elif name.startswith(RANGE):
            ranges.append((t0, t1, name[len(RANGE):]))
        elif name == "bench.slice":
            window = (t0, t1)
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            launches[e.id] = t0
    if window is None or not ranges or not dev:
        return {}
    w0, w1 = window
    segs = _segments(ranges)
    starts = [s[0] for s in segs]
    device_s: Dict[str, float] = defaultdict(float)
    migrate = 0.0
    for t0, t1, cid in dev:
        launch = launches.get(cid)
        path = () if launch is None else _at(segs, starts, launch)
        key = path[-1] if path else ("unattributed" if launch is None else "outside")
        device_s[key] += (t1 - t0) * 1e-6
        if "migrate" in path:
            migrate += (t1 - t0) * 1e-6
    # idle: the window less the union of device activity, cut by segment
    busy: List[List[float]] = []
    for t0, t1, _ in sorted(dev):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        if busy and t0 <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t1)
        else:
            busy.append([t0, t1])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    idle: Dict[str, float] = defaultdict(float)
    idle_path: Dict[str, float] = defaultdict(float)
    in_moe = 0.0
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, path = segs[k]
            lap = min(b, s1) - max(a, s0)
            if lap > 0:
                idle[path[-1]] += lap * 1e-6
                idle_path["/".join(path)] += lap * 1e-6
                covered += lap
                if any(n in MOE for n in path):
                    in_moe += lap * 1e-6
            k += 1
        idle["outside"] += (b - a - covered) * 1e-6
    decodes = sum(1 for t0, _, n in ranges if n == "decode" and w0 <= t0 < w1)
    return {"window_s": (w1 - w0) * 1e-6, "idle_s": dict(idle), "idle_path_s": dict(idle_path),
            "idle_in_moe_s": in_moe,
            "device_s": dict(device_s), "migrate_device_s": migrate, "decode_steps": decodes}


def slice_reduction() -> dict:
    """`reduce_program_ranges` of the run's traced slice, once per slice;
    empty without a profiled slice or without `trimoe.` ranges in it."""
    events = _profile_events()
    if events is None:
        return {}
    if LAST.get("events") is not events:
        LAST.clear()
        LAST.update(events=events, reduction=reduce_program_ranges(events))
    return LAST["reduction"]
