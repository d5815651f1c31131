"""Share of the window's decode MoE calls that replayed a CUDA graph, in
percent: of the `moe` spans inside a `decode` span (same thread), those
whose `graph` arg is "replay", the traced slice left out (layer: tiered
MoE; program spans). None where no `moe` span carries a `graph` arg, as
in a program that captures no graph."""
import bisect

from program_trace import window_spans


def read(rec):
    moes = [m for m in window_spans(rec, "moe") if "graph" in m.get("args", {})]
    decodes = sorted(window_spans(rec, "decode"), key=lambda e: e["ts"])
    starts = [e["ts"] for e in decodes]
    inside = []
    for m in moes:
        i = bisect.bisect_right(starts, m["ts"]) - 1
        if i >= 0:
            d = decodes[i]
            if d["tid"] == m["tid"] and m["ts"] + m["dur"] <= d["ts"] + d["dur"]:
                inside.append(m)
    if not inside:
        return None
    return 100.0 * sum(m["args"]["graph"] == "replay" for m in inside) / len(inside)
