"""Distinct experts a MoE layer's decode step sends tokens to, averaged
over the window's decode steps and MoE layers (layer: tiered MoE)."""
import numpy as np


def read(rec):
    touched = [int((c.counts > 0).sum()) for c in rec.moe_calls if c.decode]
    return float(np.mean(touched)) if touched else None
