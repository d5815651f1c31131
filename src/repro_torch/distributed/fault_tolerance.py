"""Fault tolerance & elasticity for 1000+-node operation (a copy of
repro/distributed/fault_tolerance.py, pure Python).

Mechanisms implemented here and in checkpoint/:

1. Checkpoint/restart: async, atomic (write-tmp + rename), every N steps;
   `latest_step()` + auto-resume in launch/train.py. Checkpoints store
   per-leaf npz shards keyed by tree path, so a restart on a DIFFERENT
   mesh shape re-shards transparently (elastic scaling: the restore path
   only needs the global arrays; placing them on a new mesh is the
   distributed slice's).

2. Straggler mitigation: a per-step deadline watchdog. On TPU pods,
   stragglers manifest as slow hosts, not slow chips; the watchdog
   records step-time EWMA and flags steps exceeding `k` sigma. The
   mitigation at scale is pod-level: evict the slow host from the DCN
   group and continue data-parallel on the survivors from the last
   checkpoint (the elastic path above). The decision logic is here; the
   orchestration hook (re-exec with a smaller pod axis) is in
   launch/train.py.

3. Preemption safety: SIGTERM triggers a final synchronous checkpoint
   (install_preemption_handler).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StepWatchdog:
    """EWMA step-time straggler detector."""

    alpha: float = 0.1
    k_sigma: float = 3.0
    min_steps: int = 10
    ewma: float = 0.0
    ewvar: float = 0.0
    steps: int = 0
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        if self.steps < self.min_steps:
            self.ewma = dt if self.steps == 0 else (
                self.alpha * dt + (1 - self.alpha) * self.ewma
            )
            self.steps += 1
            return False
        dev = dt - self.ewma
        # variance must be primed before flagging (first window after
        # min_steps only trains the estimator)
        primed = self.steps >= 2 * self.min_steps
        floor = 0.05 * max(self.ewma, 1e-9)  # ignore sub-5% jitter
        slow = primed and dt > self.ewma + max(
            self.k_sigma * self.ewvar ** 0.5, floor
        )
        self.steps += 1
        if slow:
            # outliers must not contaminate the healthy baseline —
            # otherwise persistent stragglers become the "new normal"
            self.flagged.append(step)
            return True
        self.ewvar = self.alpha * dev * dev + (1 - self.alpha) * self.ewvar
        self.ewma = self.alpha * dt + (1 - self.alpha) * self.ewma
        return False


@dataclass
class ElasticPolicy:
    """Decide whether to shrink the pod axis after repeated stragglers."""

    max_flags_per_window: int = 5
    window: int = 100

    def should_reshard(self, watchdog: StepWatchdog, step: int) -> bool:
        recent = [s for s in watchdog.flagged if s > step - self.window]
        return len(recent) >= self.max_flags_per_window


def install_preemption_handler(save_fn: Callable[[], None]) -> None:
    """Run a final checkpoint on SIGTERM (preemption notice)."""

    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
