"""Model FLOPs of the tokens computed in the traced slice (decode tokens
and uncached prefill tokens, at their context lengths, with their logits
rows) over the slice's seconds times the card's peak, in percent: the
whole step's share of the peak (moves tokens_per_s)."""


def read(rec):
    return rec.mfu_pct()
