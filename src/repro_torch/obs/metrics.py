"""Typed metrics registry — the one stat surface under the serving stack.

Before this module the reproduction had four disjoint ad-hoc stat
surfaces (LoopStats, engine.stats, predictor.stats, per-mode
serving_bench dicts). They now all sit on a `MetricsRegistry` of typed
instruments:

  Counter    — monotonically accumulating scalar (`+=` via the facades)
  Gauge      — last-written scalar; `DerivedGauge` evaluates a callback
               at snapshot time (tokens/s, mean utilization, ...)
  Histogram  — raw sample list with robust p50/p95 built in (the
               ttft/itl/plan latency distributions)

`MetricsRegistry.snapshot()` returns ONE flat dict (histograms expand
to .count/.sum/.mean/.p50/.p95) — benchmarks/serving_bench.py derives
every mode's JSON from it, so BENCH gating and live telemetry can never
diverge. `prometheus_text()` renders the same state in the Prometheus
exposition format for scraping / artifact upload.

`RegistryStats` is the compatibility facade the legacy dataclasses
(LoopStats / EngineStats / PredictorStats) became: attribute reads and
writes (`stats.admitted += 1`, `stats.ttft_s.append(...)`) transparently
hit registry instruments, so every pre-existing call site keeps working.

Accumulate-vs-reset contract: instruments ACCUMULATE for the lifetime
of the registry (across `ServingLoop.run()` calls). Call
`reset()` — on a facade (resets only its own instruments) or on the
registry (resets everything) — between timed passes, as serving_bench
does. Zero dependencies beyond numpy.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


def pct(xs, q: float) -> float:
    """Percentile with well-defined edge behavior: empty input -> 0.0,
    single sample -> that sample — no numpy warnings either way."""
    n = len(xs)
    if n == 0:
        return 0.0
    if n == 1:
        return float(xs[0])
    return float(np.percentile(np.asarray(xs, np.float64), q))


class Counter:
    """Monotonic accumulator (float-valued so wall-clock seconds and
    utilization mass can be counters too)."""

    kind = "counter"
    __slots__ = ("name", "unit", "desc", "source", "value")

    def __init__(self, name: str, unit: str = "", desc: str = "",
                 source: str = ""):
        self.name, self.unit, self.desc, self.source = name, unit, desc, source
        self.value = 0

    def add(self, n=1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[self.name] = self.value


class Gauge:
    """Last-written scalar."""

    kind = "gauge"
    __slots__ = ("name", "unit", "desc", "source", "value")

    def __init__(self, name: str, unit: str = "", desc: str = "",
                 source: str = ""):
        self.name, self.unit, self.desc, self.source = name, unit, desc, source
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0.0

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[self.name] = self.value


class DerivedGauge:
    """Gauge whose value is a callback evaluated at read/snapshot time —
    ratios over live counters (tokens/s, mean utilization) stay
    consistent with their inputs by construction."""

    kind = "gauge"
    __slots__ = ("name", "unit", "desc", "source", "fn")

    def __init__(self, name: str, fn: Callable[[], float], unit: str = "",
                 desc: str = "", source: str = ""):
        self.name, self.unit, self.desc, self.source = name, unit, desc, source
        self.fn = fn

    @property
    def value(self) -> float:
        return float(self.fn())

    def reset(self) -> None:  # derived from other instruments; stateless
        pass

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[self.name] = self.value


class Histogram:
    """Raw-sample histogram: `samples` is the live list the legacy code
    appends to (`stats.ttft_s.append(...)`); percentiles use the robust
    `pct` (empty -> 0.0, single sample -> itself, no numpy warnings)."""

    kind = "histogram"
    __slots__ = ("name", "unit", "desc", "source", "samples")

    def __init__(self, name: str, unit: str = "", desc: str = "",
                 source: str = ""):
        self.name, self.unit, self.desc, self.source = name, unit, desc, source
        self.samples: List[float] = []

    def observe(self, x: float) -> None:
        self.samples.append(x)

    append = observe  # list-style alias (facades expose the raw list)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(np.sum(self.samples)) if self.samples else 0.0

    @property
    def mean(self) -> float:
        return self.sum / max(self.count, 1)

    def pct(self, q: float) -> float:
        return pct(self.samples, q)

    def reset(self) -> None:
        self.samples.clear()

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[f"{self.name}.count"] = self.count
        out[f"{self.name}.sum"] = self.sum
        out[f"{self.name}.mean"] = self.mean
        out[f"{self.name}.p50"] = self.pct(50)
        out[f"{self.name}.p95"] = self.pct(95)


class MetricsRegistry:
    """Name -> instrument map with get-or-create registration.

    Re-registering an existing name returns the existing instrument
    (so a facade re-bound onto a shared registry aliases, not shadows);
    re-registering under a different kind is an error.
    """

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, unit: str, desc: str,
                       source: str):
        m = self._instruments.get(name)
        if m is not None:
            if m.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"cannot re-register as {cls.kind}"
                )
            return m
        m = cls(name, unit=unit, desc=desc, source=source)
        self._instruments[name] = m
        return m

    def counter(self, name: str, unit: str = "", desc: str = "",
                source: str = "") -> Counter:
        return self._get_or_create(Counter, name, unit, desc, source)

    def gauge(self, name: str, unit: str = "", desc: str = "",
              source: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, unit, desc, source)

    def histogram(self, name: str, unit: str = "", desc: str = "",
                  source: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, unit, desc, source)

    def derived(self, name: str, fn: Callable[[], float], unit: str = "",
                desc: str = "", source: str = "") -> DerivedGauge:
        """Get-or-create a DerivedGauge; an existing one is re-pointed at
        `fn` so a fresh facade on a shared registry reads its own state."""
        m = self._instruments.get(name)
        if m is not None:
            if not isinstance(m, DerivedGauge):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"cannot re-register as derived gauge"
                )
            m.fn = fn
            return m
        m = DerivedGauge(name, fn, unit=unit, desc=desc, source=source)
        self._instruments[name] = m
        return m

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def get(self, name: str):
        return self._instruments.get(name)

    def metrics(self) -> List[object]:
        return list(self._instruments.values())

    def snapshot(self) -> Dict[str, float]:
        """ONE flat dict of every instrument's current value (histograms
        expand to .count/.sum/.mean/.p50/.p95) — the source every bench
        JSON is derived from."""
        out: Dict[str, float] = {}
        for m in self._instruments.values():
            m.snapshot_into(out)
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition-format dump of the same state (metric
        names sanitized to [a-z0-9_]; histograms rendered as summaries
        with p50/p95 quantiles)."""
        lines: List[str] = []
        for m in self._instruments.values():
            name = _prom_name(m.name, m.unit)
            if m.desc:
                lines.append(f"# HELP {name} {m.desc}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if m.kind == 'histogram' else m.kind}")
            if m.kind == "histogram":
                lines.append(f'{name}{{quantile="0.5"}} {m.pct(50):.9g}')
                lines.append(f'{name}{{quantile="0.95"}} {m.pct(95):.9g}')
                lines.append(f"{name}_sum {m.sum:.9g}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {float(m.value):.9g}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero EVERY instrument (the registry-wide analogue of
        `LoopStats.reset()` — on a registry shared across loop, engine,
        and predictor this resets all three facades)."""
        for m in self._instruments.values():
            m.reset()


def _prom_name(name: str, unit: str = "") -> str:
    out = "".join(
        c if c.isalnum() or c == "_" else "_" for c in name.lower()
    )
    if unit and not out.endswith("_" + unit.lower()):
        suffix = "".join(c if c.isalnum() else "_" for c in unit.lower())
        out = f"{out}_{suffix}"
    return out


class RegistryStats:
    """Base for the registry-backed stat facades (LoopStats /
    EngineStats / PredictorStats).

    Subclasses declare COUNTERS / GAUGES / HISTS tables of
    field -> (unit, desc); instruments register under
    ``PREFIX.field`` on `registry` (a fresh private registry when none
    is given, so bare ``LoopStats()`` keeps working standalone).
    Attribute access is routed to the instruments:

      stats.admitted += 1        # counter read-modify-write
      stats.wall_s = 0.0         # gauge write
      stats.ttft_s.append(x)     # histogram: the live sample list

    so every legacy call site is source-compatible with the old
    dataclasses. `reset()` zeroes THIS facade's instruments only;
    `registry.reset()` zeroes everything sharing the registry.
    """

    PREFIX = ""
    COUNTERS: Dict[str, tuple] = {}
    GAUGES: Dict[str, tuple] = {}
    HISTS: Dict[str, tuple] = {}

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = registry if registry is not None else MetricsRegistry()
        d = self.__dict__
        d["registry"] = reg
        src = type(self).__name__
        p = self.PREFIX + "." if self.PREFIX else ""
        m: Dict[str, object] = {}
        for f, (unit, desc) in self.COUNTERS.items():
            m[f] = reg.counter(p + f, unit=unit, desc=desc, source=src)
        for f, (unit, desc) in self.GAUGES.items():
            m[f] = reg.gauge(p + f, unit=unit, desc=desc, source=src)
        for f, (unit, desc) in self.HISTS.items():
            m[f] = reg.histogram(p + f, unit=unit, desc=desc, source=src)
        d["_m"] = m

    def __getattr__(self, name):
        # only reached when normal lookup fails (i.e. not a real
        # attribute/property) — route declared fields to instruments
        m = self.__dict__.get("_m")
        inst = None if m is None else m.get(name)
        if inst is None:
            raise AttributeError(
                f"{type(self).__name__!s} has no attribute {name!r}"
            )
        return inst.samples if isinstance(inst, Histogram) else inst.value

    def __setattr__(self, name, value):
        m = self.__dict__.get("_m")
        inst = None if m is None else m.get(name)
        if inst is None:
            object.__setattr__(self, name, value)
        elif isinstance(inst, Histogram):
            inst.samples[:] = list(value)
        else:
            inst.value = value

    def reset(self) -> None:
        """Zero this facade's instruments (counters/gauges to 0,
        histograms emptied). Other facades on a shared registry are
        untouched; use `registry.reset()` for a full wipe."""
        for inst in self.__dict__["_m"].values():
            inst.reset()

    def snapshot(self) -> Dict[str, float]:
        """The backing registry's full flat snapshot (includes any other
        facades and derived gauges sharing the registry)."""
        return self.registry.snapshot()
