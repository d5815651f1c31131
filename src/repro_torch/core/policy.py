"""SchedulerPolicy: the one knob surface for online tier scheduling.

Before this module the serving loop's scheduling behavior was scattered
across bare kwargs (`plan_size=4` hard-coded on ServingLoop/engine,
`thresholds=`, predictor alpha/hysteresis buried in EMALoadPredictor
defaults) and none of it was cost-model-driven. `SchedulerPolicy`
collapses them into one frozen dataclass threaded as
`ServingLoop(scheduler=...)` / `cfg.scheduler`, resolved through
`resolve_policy` — the same single-resolution-rule pattern as
`kernels/backend.py` (`cfg.moe_backend` / `cfg.paged_attn_backend`).

The legacy `plan_size=` / `thresholds=` kwargs on ServingLoop and
TriMoEServingEngine are honored for one release behind a
DeprecationWarning (the `use_ref=`/`interpret=` contract).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.tiers import TierThresholds

__all__ = ["SchedulerPolicy", "resolve_policy"]


@dataclass(frozen=True)
class SchedulerPolicy:
    """Online tier-scheduling policy for the serving loop (paper §4.2-4.3).

    Plan sizing — how many expert migrations one replan may emit:
      `plan_size` fixed (the legacy contract: top-`plan_size` moves by
      benefit, always); or None (default) for COST-MODEL-DRIVEN sizing:
      a move is included only while its predicted per-step benefit under
      the tier cost model, amortized over `amortize_steps` future steps,
      exceeds the migration (weight-swap resharding) cost — clamped to
      [`plan_min`, `plan_max`]. `plan_min >= 1` keeps the paper's
      always-migrate-the-best-move behavior alive even when every move
      is individually below breakeven (small-batch smoke regimes).

    Bottleneck awareness: candidate moves that drain the currently most
    expensive tier (the host-side analogue of §4.2's bottleneck-aware
    refinement) are ranked ahead of equal-benefit moves elsewhere.

    Prediction / hysteresis: `ema_alpha` is Eq. 8's smoothing factor;
    `hysteresis` is the fractional tier-boundary margin a load must
    clear before the decision flips (suppresses tier thrash — counted
    as `thrash_events` when an expert returns to a tier it left within
    `thrash_window` replans).

    Cadence: predictor observation happens every decode group step;
    plans are drawn every `replan_every` steps. `freeze=True` pins the
    current (static) tier placement: observe-only, no migrations — the
    baseline arm of `serving_bench --skew`.
    """

    # plan sizing
    plan_min: int = 1
    plan_max: int = 8
    plan_size: Optional[int] = None  # fixed size (legacy); None = dynamic
    # prediction
    ema_alpha: float = 0.3
    hysteresis: float = 0.15
    thresholds: TierThresholds = field(default_factory=TierThresholds)
    # cost model driving dynamic sizing: "tpu" = TPUDomains deltas
    # (seconds), "loads" = pure EMA-load ranking (no breakeven gate)
    cost_mode: str = "tpu"
    amortize_steps: float = 8.0  # migration-cost amortization horizon
    # cadence / thrash accounting
    replan_every: int = 1
    thrash_window: int = 4  # replans; return within it = a thrash event
    freeze: bool = False  # static tiers: observe but never migrate

    def __post_init__(self):
        if self.plan_size is not None and self.plan_size < 1:
            raise ValueError(f"plan_size must be >= 1, got {self.plan_size}")
        if not (0 <= self.plan_min <= self.plan_max):
            raise ValueError(
                f"need 0 <= plan_min <= plan_max, got "
                f"[{self.plan_min}, {self.plan_max}]"
            )
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError(f"ema_alpha must be in (0, 1], got {self.ema_alpha}")
        if self.hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {self.hysteresis}")
        if self.cost_mode not in ("tpu", "loads"):
            raise ValueError(
                f'cost_mode must be "tpu" or "loads", got {self.cost_mode!r}'
            )
        if self.replan_every < 1:
            raise ValueError(f"replan_every must be >= 1, got {self.replan_every}")

    @property
    def plan_rows(self) -> int:
        """Fixed row count of the jitted migration-plan array (padded
        with no-ops) — constant per policy, so `apply_migrations`
        compiles exactly once regardless of dynamic sizing."""
        return self.plan_size if self.plan_size is not None else self.plan_max


def resolve_policy(
    cfg=None,
    scheduler: Optional[SchedulerPolicy] = None,
    *,
    plan_size: Optional[int] = None,
    thresholds: Optional[TierThresholds] = None,
    caller: str = "ServingLoop",
) -> SchedulerPolicy:
    """One resolution rule for the scheduling policy.

    Precedence: explicit `scheduler` > `cfg.scheduler` > defaults. The
    deprecated bare kwargs (`plan_size=`, `thresholds=`) are folded into
    the resolved policy behind a DeprecationWarning — honored for one
    release, exactly the `use_ref=`/`interpret=` contract kernel ops
    kept in PR 6."""
    policy = scheduler
    if policy is None and cfg is not None:
        policy = getattr(cfg, "scheduler", None)
    if policy is None:
        policy = SchedulerPolicy()
    if not isinstance(policy, SchedulerPolicy):
        raise TypeError(
            f"{caller}: scheduler must be a SchedulerPolicy, got "
            f"{type(policy).__name__}"
        )
    legacy = {}
    if plan_size is not None:
        legacy["plan_size"] = plan_size
    if thresholds is not None:
        legacy["thresholds"] = thresholds
    if legacy:
        warnings.warn(
            f"{caller}: the bare {'/'.join(sorted(legacy))} kwarg(s) are "
            f"deprecated; pass scheduler=SchedulerPolicy(...) (or set "
            f"cfg.scheduler) instead — resolved by "
            f"repro_torch.core.policy.resolve_policy",
            DeprecationWarning,
            stacklevel=3,
        )
        policy = dataclasses.replace(policy, **legacy)
    return policy
