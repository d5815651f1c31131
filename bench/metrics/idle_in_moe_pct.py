"""Share of the traced slice in which the card is idle while the host is
inside the tiered MoE (its innermost `trimoe.` range `moe` or one of its
children), in percent (layer: tiered MoE; device trace)."""
from program_trace import slice_reduction


def read(rec):
    r = slice_reduction()
    return 100.0 * r["idle_in_moe_s"] / r["window_s"] if r else None
