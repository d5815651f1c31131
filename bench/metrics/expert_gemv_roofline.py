"""The expert GEMV's share of its roofline over the traced slice, in
percent: the decode MoE calls' bounds (the live experts' weights and the
dispatched rows, over HBM bandwidth) over the device time of the GEMV's
launches (its live-row prepass, gate|up and down passes; the fp32
panel and split-reduce kernels)."""

KERNELS = r"\b(live_rows|gateup|down|gemv_panel|reduce_splits)_kernel\b"


def read(rec):
    return rec.roofline_pct(KERNELS, decode=True)
