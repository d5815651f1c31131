"""Where a benchmark cell's decode step goes, from the program's own spans:
one traced run of the cell (`bench/run.py --trace 1`), then

  * the host split of the window's decode steps (the traced slice left
    out): per step, the median milliseconds in the layers' mixers, the
    dense FFNs, the MoE and its route / tiers / combine, the head, the
    blocking copies (`sync`, by what they copy), the replan and the
    migrations, and the decode span's own remainder;
  * the traced slice's idle time of the card by the innermost program
    range open on the host (and by the whole nest), and the device time
    of the work launched inside each range (bench/program_trace.py).

    python3 tools/program_split.py --workload deepseek-v2-lite.chat --seed 7 \\
        --seconds 45 [--out chiprun_out/split.json]

Run from the root of a checkout on a machine with a CUDA card; prints one
JSON object (and writes it to --out).
"""
import time

T_START = time.time()  # noqa: E402  (the run's set-up is timed from here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
PARTS = ("layer.mixer", "layer.ffn", "moe", "moe.route", "moe.tier", "moe.combine",
         "model.head", "sync", "replan", "migrate")
TOP = ("layer.mixer", "layer.ffn", "moe", "model.head", "sync", "replan", "migrate")


def host_split(rec) -> dict:
    """Median host milliseconds per window decode step of each part
    (`rec.window_s`: the run's window)."""
    import numpy as np

    from program_trace import per_span_ms, window_spans

    decodes = sorted(window_spans(rec, "decode"), key=lambda e: e["ts"])
    if not decodes:
        return {}
    parts = {n: per_span_ms(rec, "decode", (n,)) or [0.0] * len(decodes) for n in PARTS}
    total = [e["dur"] * 1e-3 for e in decodes]
    own = [t - sum(parts[n][i] for n in TOP) for i, t in enumerate(total)]
    out = {n: float(np.median(v)) for n, v in parts.items()}
    out.update(decode=float(np.median(total)), decode_self=float(np.median(own)),
               decode_steps=len(decodes))
    return out


def sync_split(rec) -> dict:
    """Per window decode step, the median milliseconds of each kind of
    blocking copy, and the copies a step makes."""
    import numpy as np

    from program_trace import program_events, window_spans

    events = program_events() or []
    syncs = sorted((e for e in events if e.get("ph") == "X" and e["name"] == "sync"),
                   key=lambda e: e["ts"])
    per = []
    for d in window_spans(rec, "decode"):
        t0, t1 = d["ts"], d["ts"] + d["dur"]
        got = defaultdict(float)
        for e in syncs:
            if t0 <= e["ts"] and e["ts"] + e["dur"] <= t1:
                got[e["args"]["what"]] += e["dur"] * 1e-3
                got["copies"] += 1
        per.append(got)
    keys = sorted({k for g in per for k in g})
    return {k: float(np.median([g.get(k, 0.0) for g in per])) for k in keys}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import harness
    import program_trace

    out = harness.run_cell(BENCH, args.workload, args.seed, args.seconds, True, T_START)
    # the program's tracer outlives the run's loop; the window is the run's
    window = SimpleNamespace(window_s=out["diagnostics"]["window_s"])
    red = program_trace.LAST.get("reduction", {})
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:30])  # noqa: E731
    line = {"workload": args.workload, "seed": args.seed, "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "device": out["device"], "host_ms_per_decode": host_split(window),
            "sync_ms_per_decode": sync_split(window),
            "slice": {k: (top(v) if isinstance(v, dict) else v) for k, v in red.items()},
            "breakdown": out.get("breakdown"),
            "diagnostics": out["diagnostics"]}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
