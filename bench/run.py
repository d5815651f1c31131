"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits non-zero, printing no result, without
a CUDA card (or with fewer cards than the cell asks for), and if JAX, its
relatives or the JAX package were loaded in this process. The last lines
of standard error, and the `checks` key that comes last in the result
line, give each number compared beside its limit.
"""
import time

T_START = time.time()  # noqa: E402  (set-up is timed from process start)

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the float8 control's gap on the same sample")
    ap.add_argument("--rate", type=float, default=None,
                    help="an open loop's arrivals a second instead of the cell's (the knee sweep)")
    args = ap.parse_args()
    # every cache of this run inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch

    from harness import as_json_line, load_cell, run_cell

    chips = load_cell(BENCH, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = run_cell(BENCH, args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                   control=bool(args.control), rate=args.rate)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     **out["device"], "count": chips}
    checks = out.pop("checks")
    out["checks"] = checks  # the last key of the line
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(as_json_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
