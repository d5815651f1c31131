"""Host milliseconds a step waits on host<->device copies that block it
(uploads from pageable memory, reads of tokens and expert counts): each
step's `sync` spans summed, the median over the window's steps, the
traced slice left out (layer: loop; program spans)."""
from program_trace import p50, per_span_ms


def read(rec):
    return p50(per_span_ms(rec, "step", ("sync",)))
