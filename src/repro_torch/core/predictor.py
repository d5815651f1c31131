"""Expert Load Predictor (paper §4.3, Eq. 8).

Per-expert exponential moving average, updated after every decode step:
    EMA_e(t) = alpha * F_e(t) + (1 - alpha) * EMA_e(t-1),  alpha = 0.3.

Metadata footprint matches the paper's 38 KB claim: one fp32 per
(layer, expert) — DeepSeek-V2's 60 x 160 grid is exactly 38.4 KB.

Accuracy metric = fraction of (layer, expert) cells whose *predicted tier*
(classify(EMA)) equals the realized tier of the next step — the paper's
"migration decision accuracy" (>78%).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.tiers import COLD, HOT, WARM, TierThresholds, classify
from repro_torch.obs.metrics import MetricsRegistry, RegistryStats


class PredictorStats(RegistryStats):
    """Registry-backed prediction accuracy counters (repro_torch.obs) under
    the `predictor.*` prefix; field access is source-compatible with the
    old dataclass. Pass the serving stack's shared registry to land
    these on the same snapshot as the loop/engine metrics."""

    PREFIX = "predictor"
    COUNTERS = {
        "decisions": ("cells", "(layer, expert) tier predictions scored"),
        "correct": ("cells", "predictions matching the realized tier"),
        "migrations": ("cells", "cells where the predicted tier changed"),
        "migrations_correct": (
            "cells", "tier transitions matching the realized tier"),
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        super().__init__(registry)
        self.registry.derived(
            "predictor.accuracy", lambda: self.accuracy,
            desc="tier-prediction accuracy over all cells",
            source="PredictorStats",
        )
        self.registry.derived(
            "predictor.migration_accuracy", lambda: self.migration_accuracy,
            desc="accuracy restricted to predicted tier transitions",
            source="PredictorStats",
        )

    @property
    def accuracy(self) -> float:
        """Tier-prediction accuracy over all (layer, expert) cells."""
        return self.correct / max(self.decisions, 1)

    @property
    def migration_accuracy(self) -> float:
        """Accuracy restricted to predicted tier *transitions* — the cells
        that actually trigger migration tasks (the paper's ~78% number)."""
        return self.migrations_correct / max(self.migrations, 1)


class EMALoadPredictor:
    def __init__(
        self,
        n_layers: int,
        n_experts: int,
        alpha: float = 0.3,
        thresholds: TierThresholds = TierThresholds(),
        hysteresis: float = 0.15,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.alpha = alpha
        self.th = thresholds
        self.hysteresis = hysteresis  # fractional threshold margin for decisions
        self.ema = np.zeros((n_layers, n_experts), dtype=np.float32)
        self._primed = np.zeros(n_layers, dtype=bool)
        self._prev_real = np.zeros((n_layers, n_experts), dtype=np.int8)
        self.decided = np.full((n_layers, n_experts), WARM, dtype=np.int8)
        self.stats = PredictorStats(registry)

    @property
    def metadata_bytes(self) -> int:
        return self.ema.nbytes

    def predict(self, layer: int) -> np.ndarray:
        """Predicted per-expert load for the next step of `layer`."""
        return self.ema[layer].copy()

    def predict_tiers(self, layer: int) -> np.ndarray:
        return classify(self.ema[layer], self.th)

    def decide_tiers(self, layer: int) -> np.ndarray:
        """Hysteresis decision: only migrate when the EMA clears a tier
        boundary by the margin, suppressing boundary flicker (the noise
        suppression role the paper assigns to the tuned alpha)."""
        v = self.ema[layer]
        cur = self.decided[layer].copy()
        m = self.hysteresis
        th, tc = self.th.tau_hot, self.th.tau_cold
        new = cur.copy()
        new[(cur != HOT) & (v >= th * (1 + m))] = HOT
        new[(cur == HOT) & (v < th * (1 - m))] = WARM
        new[(cur != COLD) & (v <= tc * (1 - m))] = COLD
        new[(cur == COLD) & (v > tc * (1 + m))] = WARM
        self.decided[layer] = new
        return new

    def update(self, layer: int, loads: np.ndarray) -> None:
        """Called after `layer` finishes a decode step (Eq. 8)."""
        loads = np.asarray(loads, dtype=np.float32)
        real = classify(loads, self.th)
        if not self._primed[layer]:
            self.ema[layer] = loads
            self._primed[layer] = True
            self._prev_real[layer] = real
            self.decided[layer] = real
            return
        # score the decision we would have made from the previous EMA
        pred = classify(self.ema[layer], self.th)
        self.stats.decisions += pred.size
        self.stats.correct += int((pred == real).sum())
        prev_decided = self.decided[layer].copy()
        decided = self.decide_tiers(layer)
        moved = decided != prev_decided  # triggered migrations
        self.stats.migrations += int(moved.sum())
        self.stats.migrations_correct += int((moved & (decided == real)).sum())
        self._prev_real[layer] = real
        self.ema[layer] = self.alpha * loads + (1 - self.alpha) * self.ema[layer]
