"""Expert tier classification (paper §3.1): hot / warm / cold.

The paper's empirical picture (Fig. 3): a long tail of cold experts
(~70% of experts, ~8% of tokens), 20-40% warm experts carrying up to 70%
of tokens, and a handful of hot experts. Thresholds follow the compute
characterization (Fig. 5a): an expert is GPU-worthy ("hot") when its
token count amortizes HBM-resident compute (>= tau_hot), and NDP-worthy
("cold") when its load is so low the job is pure weight-streaming
(<= tau_cold).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HOT, WARM, COLD = 0, 1, 2
TIER_NAMES = {HOT: "hot", WARM: "warm", COLD: "cold"}


@dataclass(frozen=True)
class TierThresholds:
    # token-count thresholds per expert per step
    tau_hot: int = 256  # Fig 5a: H100 needs >=256 tokens/expert for 30% util
    # NDP compute budget: the GEMV unit (256 GFLOP/s vs 153.6 GB/s internal)
    # breaks even at ~1.7 tokens/expert and is within ~2x of its
    # weight-streaming floor up to ~8 — beyond that an expert exceeds the
    # "limited near-data compute budget" (paper §3.1) and must be warm.
    tau_cold: int = 8


def classify(loads: np.ndarray, th: TierThresholds = TierThresholds()) -> np.ndarray:
    """loads: [..., E] token counts -> tier ids [..., E]."""
    loads = np.asarray(loads)
    tiers = np.full(loads.shape, WARM, dtype=np.int8)
    tiers[loads >= th.tau_hot] = HOT
    tiers[loads <= th.tau_cold] = COLD
    return tiers


def tier_stats(loads: np.ndarray, th: TierThresholds = TierThresholds()) -> dict:
    """Fractions of experts and of tokens per tier (reproduces Fig. 3b)."""
    loads = np.asarray(loads, dtype=np.float64).reshape(-1, loads.shape[-1])
    tiers = classify(loads, th)
    total_tokens = max(loads.sum(), 1.0)
    out = {}
    for t, name in TIER_NAMES.items():
        mask = tiers == t
        out[f"{name}_expert_frac"] = float(mask.mean())
        out[f"{name}_token_frac"] = float(loads[mask].sum() / total_tokens)
    return out
