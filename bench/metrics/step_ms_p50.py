"""Median host-clock duration of `ServingLoop.step_once` in the window,
the profiled slice left out (layer: loop)."""
from record import pct


def read(rec):
    v = pct(rec.step_s, 50)
    return None if v is None else 1e3 * v
