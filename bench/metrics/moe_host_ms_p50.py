"""Host milliseconds a decode step spends in the tiered MoE: each decode
step's `moe` spans summed (one per MoE layer: routing, the three tiers'
dispatch, expert FFN and gather, the combine), the median over the
window's decode steps, the traced slice left out (layer: tiered MoE;
program spans)."""
from program_trace import p50, per_span_ms


def read(rec):
    return p50(per_span_ms(rec, "decode", ("moe",)))
