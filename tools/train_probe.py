"""The training phases of chip_smoke.py alone, on one H100: build the
kernels, then the gradient phase (the differentiable moe_gemm at
granite's training widths, its dX products timed), the train phase
(granite-moe-1b-a400m at full width and depth, 8 steps, then generate)
with a torch.profiler window of 2 train steps (its table written to
PATH's stem-train, PATH from --profile-out), and the fp32 smoke train
parity (card vs CPU, checkpoint restore). Exits 1 where a phase fails.

  python tools/train_probe.py [--profile-out PATH]
"""
import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-out", default="profile_out/train_profile.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the probe runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cs.build.build_all()
    cs.grad_phase(dev)
    cs.train_phase(dev, profile_out=args.profile_out)
    cs.train_smoke_parity(dev)


if __name__ == "__main__":
    main()
