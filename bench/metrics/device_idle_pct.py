"""Share of the traced slice in which nothing ran on the card, in percent
(layer: device)."""


def read(rec):
    w = rec.trace.get("window_s")
    return 100.0 * (1.0 - rec.trace["busy_s"] / w) if w else None
