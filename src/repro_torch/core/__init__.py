"""TriMoE core pieces the serving path needs (copies of repro.core):

- tiers:      hot/warm/cold expert classification (§3.1)
- cost_model: Eq. 1-7 execution cost model + the TPU-domain analogue the
              migration planner scores moves with (kept verbatim so the
              port's plans equal the reference's)
- predictor:  EMA expert-load predictor (§4.3, Eq. 8)
- policy:     SchedulerPolicy, the online-scheduling knob surface
"""
from repro_torch.core.cost_model import ExpertShape, TPUDomains
from repro_torch.core.policy import SchedulerPolicy, resolve_policy
from repro_torch.core.predictor import EMALoadPredictor
from repro_torch.core.tiers import COLD, HOT, WARM, TierThresholds, classify

__all__ = [
    "COLD", "EMALoadPredictor", "ExpertShape", "HOT", "SchedulerPolicy",
    "TPUDomains", "TierThresholds", "WARM", "classify", "resolve_policy",
]
