"""Expert moves the planner emitted per decode step in the window
(layer: engine and planner)."""


def read(rec):
    n = rec.loop["decode_steps"]
    return rec.loop["migrations"] / n if n else None
