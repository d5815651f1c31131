"""Process start to the first timed step: imports, kernel load, weights,
the loop, warm-up and the ramp that fills the slots."""


def read(rec):
    return rec.setup_s
