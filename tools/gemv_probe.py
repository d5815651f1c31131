"""Where the expert GEMV's device time goes, on one H100 (needs a CUDA
card and nvcc):

  python tools/gemv_probe.py

calls the wrapper `expert_ffn_gemv` (bf16) on each case and reports the
device time of each kernel it launches (the live-row prepass, the
gate|up and the down pass; torch.profiler, eager calls). Every case
reads its weights as views of a [n, 3, D, F] tier buffer, as the serving
path does. Prints one JSON line per case and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.expert_gemv import expert_ffn_gemv  # noqa: E402

HBM_BPS = 3.35e12
# name -> (slots, tokens, D, F, live slots)
CASES = {
    "granite cold 16 slots T=8": (16, 8, 1024, 512, 16),
    "granite hot 8 slots T=4": (8, 4, 1024, 512, 8),
    "deepseek hot 25 slots T=4": (25, 4, 5120, 1536, 25),
    "deepseek warm 48 slots T=4, 8 live": (48, 4, 5120, 1536, 8),
    "deepseek cold 96 slots T=6": (96, 6, 5120, 1536, 96),
}


def case_inputs(n, t, d, f, live, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(n, 3, d, f, generator=gen, device=dev, dtype=torch.bfloat16)
    buf.mul_(d ** -0.5)
    x = torch.randn(n, t, d, generator=gen, device=dev, dtype=torch.bfloat16)
    x[live:] = 0
    return x, buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)


def profile_ms(fn, reps: int) -> dict:
    """Mean device ms per call of each kernel `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def short(key):
        m = re.search(r"::(\w+(?:<[^>]*>)?)\(", key)
        return m.group(1) if m else key[:60]
    return {short(ev.key): ev.device_time_total / 1e3 / reps
            for ev in prof.key_averages() if ev.device_time_total > 0}


def bound_ms(n, t, d, f, live):
    return (3 * live * d * f + 2 * live * t * d) * 2 / HBM_BPS * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda:0")
    for label, (n, t, d, f, live) in CASES.items():
        x, w1, w3, w2 = case_inputs(n, t, d, f, live, dev)
        ms = profile_ms(lambda: expert_ffn_gemv(x, w1, w3, w2, backend="cuda"), args.reps)
        print(json.dumps(dict(case=label, kernels_ms=ms, bound_ms=bound_ms(n, t, d, f, live))),
              flush=True)
        del x, w1, w3, w2
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
