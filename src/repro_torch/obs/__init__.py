"""Unified observability layer: metrics registry + structured tracing.

One `Observability` bundle per serving stack: a `MetricsRegistry`
(obs/metrics.py) every stat facade (LoopStats / EngineStats /
PredictorStats) registers into, and a `Tracer` (obs/trace.py) the loop,
engine, scheduler/tier channel, model layers, tiered MoE and kernel op
wrappers emit spans to.

Resolution follows the same precedence rule as `SchedulerPolicy`
(core/policy.resolve_policy) and the kernel backends
(kernels/backend.resolve_backend):

    explicit ServingLoop(obs=...)  >  cfg.obs  >  defaults

where `obs` may be a ready `Observability` (share one registry/tracer
across components — what ServingLoop hands its engine) or an
`ObsConfig` (construct a fresh bundle). Defaults: metrics on (they are
just attribute writes), tracing off (NULL_SPAN fast path).

Metrics accumulate across `run()` calls; `reset()` on a facade or the
registry starts a fresh window (see obs/metrics.py for the contract).
Export a recorded trace with `Observability.export_trace()` or
tools/export_trace_torch.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.metrics import (  # noqa: F401  (public re-exports)
    Counter,
    DerivedGauge,
    Gauge,
    Histogram,
    MetricsRegistry,
    RegistryStats,
    pct,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN,
    Tracer,
    install_tracer,
    load_trace,
    validate_trace_events,
)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Declarative observability knobs (what `cfg.obs` holds — frozen
    and hashable like the rest of ModelConfig)."""

    # record spans/instants/counter tracks (near-zero overhead off)
    trace: bool = False
    # default path for Observability.export_trace() (still explicit —
    # nothing auto-writes at finish())
    trace_path: Optional[str] = None
    # Perfetto process name on the exported timeline
    process_name: str = "repro-serving"


class Observability:
    """The live bundle: one registry + one tracer, shared by every
    component of a serving stack (loop, engine, predictor, kernels)."""

    def __init__(self, config: Optional[ObsConfig] = None):
        self.config = config if config is not None else ObsConfig()
        self.registry = MetricsRegistry()
        self.tracer = Tracer(
            enabled=self.config.trace,
            process_name=self.config.process_name,
        )

    def export_trace(self, path: Optional[str] = None) -> str:
        """Write the recorded trace to `path` (default
        config.trace_path) as Perfetto-loadable trace_event JSON."""
        path = path or self.config.trace_path
        if not path:
            raise ValueError(
                "export_trace needs a path (or ObsConfig.trace_path)"
            )
        return self.tracer.export(path)

    def snapshot(self):
        return self.registry.snapshot()

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()


def resolve_obs(cfg=None, obs=None, *, caller: str = "ServingLoop"
                ) -> Observability:
    """One resolution rule for the observability knobs, mirroring
    `resolve_policy` / `resolve_backend`: explicit `obs=` beats
    `cfg.obs` beats defaults. Accepts an `Observability` (adopted
    as-is, sharing its registry/tracer) or an `ObsConfig` (a fresh
    bundle is built). When the resolved tracer is enabled, it is also
    installed as the process-global tracer (obs/trace.py
    `install_tracer`), so the model, MoE and kernel op layers annotate
    the same timeline."""
    choice = obs
    if choice is None and cfg is not None:
        choice = getattr(cfg, "obs", None)
    if choice is None:
        choice = ObsConfig()
    if isinstance(choice, Observability):
        out = choice
    elif isinstance(choice, ObsConfig):
        out = Observability(choice)
    else:
        raise TypeError(
            f"{caller}: obs= must be Observability | ObsConfig | None, "
            f"got {type(choice).__name__}"
        )
    if out.tracer.enabled:
        install_tracer(out.tracer)
    return out
