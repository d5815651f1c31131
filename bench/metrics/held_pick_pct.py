"""Share of the window's decode top-k assignments that went to the experts
held here, in percent: the growth over the window of the loop's running
totals that each `decode` span carries (`held_picks`, the decode MoE
calls' expert counts summed; `routed_picks`, top_k x MoE layers x live
tokens), the first such span's totals subtracted from the last's (layer:
tiered MoE; program counters). 25% under even routing over a quarter of
the experts. None where no `decode` span carries them, as in a program
without the counters."""
from program_trace import program_events


def read(rec):
    events = program_events()
    if not events:
        return None
    steps = [e for e in events if e.get("ph") == "X" and e["name"] == "step"]
    if not steps:
        return None
    end = max(e["ts"] + e["dur"] for e in steps)
    start = end - rec.window_s * 1e6 - 1e3
    marks = sorted((e for e in events if e.get("ph") == "X" and e["name"] == "decode"
                    and e["ts"] >= start and "held_picks" in e.get("args", {})),
                   key=lambda e: e["ts"])
    if len(marks) < 2:
        return None
    first, last = marks[0]["args"], marks[-1]["args"]
    routed = last["routed_picks"] - first["routed_picks"]
    return 100.0 * (last["held_picks"] - first["held_picks"]) / routed if routed > 0 else None
