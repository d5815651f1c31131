"""Structured tracing to Chrome/Perfetto `trace_event` JSON.

The Tracer answers "where did this decode step's 143 ms go?": the
serving loop and engine open nested spans (`step` > `admit` /
`prefill_chunk` / `decode` > `replan` / `migrate`), the scheduler/tier
channel records per-tier expert occupancy as counter tracks and
migration/thrash events as instants on the same timeline, and
`export()` writes a JSON object format file that
https://ui.perfetto.dev (or chrome://tracing) loads directly.

Event phases used (Trace Event Format):
  "X" complete span  — ts + dur (microseconds); nesting is by
                       containment per (pid, tid) track
  "i" instant        — a point event (migrations, thrash)
  "C" counter        — a stacked counter track (tier occupancy, slots)
  "M" metadata       — process/thread naming

Overhead contract: a disabled tracer's `span()` returns a shared no-op
context manager and `instant()`/`counter()` return immediately — no
event dicts, no clock reads, no allocation beyond the call itself —
so tracing can stay compiled into the hot path (the serving_bench
overhead gate runs with tracing disabled). Timestamps are
`time.perf_counter()` relative to tracer construction, in microseconds;
`reset()` drops the events and keeps that origin, and
`Tracer.perf_counter_s` maps a timestamp back to `time.perf_counter()`
seconds.

One process-global slot holds the tracer the model, MoE and kernel code
emit to (`install_tracer`, done by `repro_torch.obs.resolve_obs` when a
stack resolves with tracing on; `active_tracer` reads it). Those layers
reach it there, so no signature carries a tracer.

On the profiler's clock: while a `torch.profiler` (or any torch
profiler) records, every span of an enabled tracer also opens a range
named `trimoe.<span name>` on the profiler's own timeline, beside the
kernels the span launched, and its event carries `profiled: true`. The
range is a function-scope record (as an aten op's), so the profiler
draws no device-side copy of it: device activity stays the kernels',
copies' and sets'.

Imports json/threading/time only; torch is imported on the first span
of an enabled tracer.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

RANGE_PREFIX = "trimoe."  # the profiler ranges' names: trimoe.<span name>
_perf_counter = time.perf_counter
_get_ident = threading.get_ident

# torch's "is a profiler recording" and its function-scope record, bound
# on the first span of an enabled tracer (never true / None without torch)
_PROFILER_ON = None
_RECORD = None


def _bind_profiler():
    global _PROFILER_ON, _RECORD
    try:
        import torch
        from torch._C._profiler import _RecordFunctionFast

        _PROFILER_ON, _RECORD = torch._C._autograd._profiler_enabled, _RecordFunctionFast
    except (ImportError, AttributeError):
        _PROFILER_ON = bool  # bool() is False
    return _PROFILER_ON


class _Span:
    """One open "X" span; the event is recorded at __exit__."""

    __slots__ = ("_tr", "name", "cat", "args", "_t0", "_range")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._range = None
        if (_PROFILER_ON or _bind_profiler())():
            self._range = _RECORD(RANGE_PREFIX + self.name)
            self._range.__enter__()
            self.args["profiled"] = True
        self._t0 = _perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = _perf_counter()
        tr = self._tr
        if self._range is not None:
            self._range.__exit__(None, None, None)
        ts = (self._t0 - tr._t0) * 1e6
        ev: Dict[str, Any] = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": ts,
            "dur": (t1 - tr._t0) * 1e6 - ts,
            "pid": tr.pid,
            "tid": _get_ident(),
        }
        if self.args:
            ev["args"] = self.args
        tr.events.append(ev)
        return False


class Tracer:
    """Collects trace events in memory; export when the run is done.

    Construct enabled via `ObsConfig(trace=True)` (resolved by
    `repro_torch.obs.resolve_obs`). `enabled` may also be flipped at runtime
    to bracket a region of interest.
    """

    def __init__(self, enabled: bool = False,
                 process_name: str = "repro-serving"):
        self.enabled = enabled
        self.process_name = process_name
        self.pid = 1
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # ------------------------------------------------------------- emit
    def span(self, name: str, cat: str = "serving", **args):
        """Context manager recording a complete ("X") span around the
        `with` body. No-op (shared NULL_SPAN) when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "serving", **args) -> None:
        """Point event ("i", thread-scoped) — migrations, thrash."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "serving") -> None:
        """Counter track sample ("C") — Perfetto renders one stacked
        track per `name` with a series per key in `values`."""
        if not self.enabled:
            return
        self.events.append({
            "name": name,
            "cat": cat,
            "ph": "C",
            "ts": self._now_us(),
            "pid": self.pid,
            "args": {k: float(v) for k, v in values.items()},
        })

    # ----------------------------------------------------------- export
    def to_trace_events(self) -> List[Dict[str, Any]]:
        """Metadata + collected events, ready to wrap as
        {"traceEvents": [...]}."""
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": self.pid,
            "args": {"name": self.process_name},
        }]
        return meta + list(self.events)

    def export(self, path: str) -> str:
        """Write the JSON object format Perfetto/chrome://tracing load."""
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": self.to_trace_events(),
                 "displayTimeUnit": "ms"},
                f,
            )
        return path

    def reset(self) -> None:
        """Drop the recorded events; the clock keeps its origin."""
        self.events.clear()

    def perf_counter_s(self, ts_us: float) -> float:
        """The `time.perf_counter()` reading of event timestamp `ts_us`."""
        return self._t0 + ts_us * 1e-6


# ------------------------------------------------- the process-global slot
_INSTALLED: Optional[Tracer] = None


def install_tracer(tracer: Optional[Tracer]) -> None:
    """Install (or clear, with None) the process-global tracer that model,
    MoE and kernel code emit to (the last stack resolved with tracing on
    wins)."""
    global _INSTALLED
    _INSTALLED = tracer


def active_tracer() -> Optional[Tracer]:
    """The installed tracer if it is enabled, else None: callers write
    `tr.span(...) if tr else NULL_SPAN`, so a disabled path builds no
    arguments, reads no clock and allocates nothing."""
    tr = _INSTALLED
    return tr if tr is not None and tr.enabled else None


def sync_span(tr: Optional[Tracer], what: str):
    """A `sync` span of `tr` around one host<->device copy that blocks the
    host (`what` names it); NULL_SPAN when `tr` is None or disabled."""
    if tr is None or not tr.enabled:
        return NULL_SPAN
    return _Span(tr, "sync", "sync", {"what": what})


def validate_trace_events(events: List[Dict[str, Any]]) -> List[str]:
    """Structural validation of a trace_event list; returns a list of
    problems (empty = valid). Checks the fields Perfetto requires and
    that "X" spans on each (pid, tid) track nest by strict containment
    (a child span must close before its parent — guaranteed by the
    context-manager discipline, so a violation means clock or
    bookkeeping corruption). Used by tools/export_trace.py --check and
    the round-trip tests."""
    problems: List[str] = []
    spans: Dict[tuple, List[tuple]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing/empty name")
            continue
        if ph not in ("X", "i", "I", "C", "M", "B", "E"):
            problems.append(f"event {i} ({ev['name']}): unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ev['name']}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({ev['name']}): bad dur {dur!r}"
                )
                continue
            key = (ev.get("pid"), ev.get("tid"))
            spans.setdefault(key, []).append((ts, ts + dur, ev["name"]))
    # containment check per track: sweep spans by (start, longest-first);
    # any span overlapping the enclosing open span must end inside it
    for key, track in spans.items():
        track.sort(key=lambda s: (s[0], -(s[1] - s[0])))
        stack: List[tuple] = []
        for t0, t1, name in track:
            while stack and stack[-1][1] <= t0:
                stack.pop()
            if stack and t1 > stack[-1][1]:
                problems.append(
                    f"track {key}: span {name!r} [{t0:.1f}, {t1:.1f}] "
                    f"overlaps but escapes enclosing {stack[-1][2]!r} "
                    f"[{stack[-1][0]:.1f}, {stack[-1][1]:.1f}]"
                )
            stack.append((t0, t1, name))
    return problems


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read a trace file in either the JSON object format
    ({"traceEvents": [...]}) or the bare JSON-array format."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(f"{path}: no traceEvents array")
        return events
    if isinstance(data, list):
        return data
    raise ValueError(f"{path}: not a trace_event JSON document")
