"""95th percentile of the planner's host latency per replan pass in the
window, in milliseconds (layer: engine and planner)."""
from record import pct


def read(rec):
    v = pct(rec.plan_s, 95)
    return None if v is None else 1e3 * v
