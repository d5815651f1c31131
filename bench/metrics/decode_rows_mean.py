"""Live rows per decode call of the engine in the window (layer: loop;
the batcher's groups fill the decode width)."""


def read(rec):
    n = rec.loop.get("decode_calls", 0)
    return rec.loop["decode_rows"] / n if n else None
