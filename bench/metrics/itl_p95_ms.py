"""95th percentile, over every gap between consecutive tokens of every
request inside the window, in milliseconds."""
from record import pct


def read(rec):
    v = pct(rec.itl_s, 95)
    return None if v is None else 1e3 * v
