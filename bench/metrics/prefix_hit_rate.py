"""Share of looked-up prompt tokens the radix prefix index served from
the paged cache in the window, in percent (layer: paged KV)."""


def read(rec):
    n = rec.loop["lookup_tokens"]
    return 100.0 * rec.loop["hit_tokens"] / n if n else None
