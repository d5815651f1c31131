"""Device milliseconds of the work launched inside `trimoe.migrate`
ranges (the planner's expert swaps) over the traced slice, per decode
step in it (layer: engine and planner; device trace)."""
from program_trace import slice_reduction


def read(rec):
    r = slice_reduction()
    if not r or not r["decode_steps"]:
        return None
    return 1e3 * r["migrate_device_s"] / r["decode_steps"]
