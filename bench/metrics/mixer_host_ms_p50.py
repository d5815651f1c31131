"""Host milliseconds a decode step spends in the layers' mixers (MLA,
GQA or Mamba): each decode step's `layer.mixer` spans summed, the median
over the window's decode steps, the traced slice left out (layer: model
layers; program spans)."""
from program_trace import p50, per_span_ms


def read(rec):
    return p50(per_span_ms(rec, "decode", ("layer.mixer",)))
