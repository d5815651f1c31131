"""95th percentile, over every request first answered in the window, of
the time from when it was due to its first token (layer: loop). Kept as a
per-layer metric: within a 45 s window it spreads between seeds far more
than an end-to-end bound could hold (PERF.md, section 2)."""
from record import pct


def read(rec):
    return pct(rec.ttft_s, 95)
