"""Generated tokens delivered in the window over the window's seconds."""


def read(rec):
    return rec.tokens / rec.window_s if rec.window_s > 0 else None
