"""TriMoE core: the paper's contribution (copies of repro.core, numpy only).

- tiers:      hot/warm/cold expert classification (§3.1)
- cost_model: Eq. 1-7 execution cost model + the TPU-domain analogue the
              migration planner scores moves with (kept verbatim so the
              port's plans equal the reference's)
- scheduler:  bottleneck-aware greedy makespan scheduling (§4.2)
- predictor:  EMA expert-load predictor (§4.3, Eq. 8)
- relayout:   prediction-driven relayout & rebalancing (§4.3)
- traces:     synthetic routing traces and replayable request traces
- policy:     SchedulerPolicy, the online-scheduling knob surface
- simulator:  event-level system simulator + baseline policies (§5); its
              times are modelled for the paper's Table-1 system
              (`repro_torch.hardware.TRIMOE_HW`), not measured
"""
from repro_torch.core.cost_model import (
    CPU,
    GPU,
    LOCALIZED,
    NDP,
    STRIPED,
    CostModel,
    ExpertShape,
    TPUDomains,
)
from repro_torch.core.policy import SchedulerPolicy, resolve_policy
from repro_torch.core.predictor import EMALoadPredictor
from repro_torch.core.relayout import MigrationTask, RelayoutEngine
from repro_torch.core.scheduler import ExpertPlacement, MakespanScheduler, Schedule
from repro_torch.core.simulator import SimFlags, SimModel, SimResult, TriMoESimulator, simulate
from repro_torch.core.tiers import COLD, HOT, WARM, TierThresholds, classify, tier_stats
from repro_torch.core.traces import (
    RequestTrace,
    RoutingTrace,
    TraceSpec,
    generate_trace,
    load_trace,
    synth_request_trace,
    trace_for_model,
)

__all__ = [
    "CPU", "GPU", "NDP", "STRIPED", "LOCALIZED", "HOT", "WARM", "COLD",
    "CostModel", "ExpertShape", "TPUDomains", "EMALoadPredictor",
    "MigrationTask", "RelayoutEngine", "ExpertPlacement", "MakespanScheduler",
    "Schedule", "SchedulerPolicy", "resolve_policy", "SimFlags", "SimModel",
    "SimResult", "TriMoESimulator", "simulate", "TierThresholds", "classify",
    "tier_stats", "TraceSpec", "RoutingTrace", "RequestTrace",
    "generate_trace", "load_trace", "synth_request_trace", "trace_for_model",
]
