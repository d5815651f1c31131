"""End-to-end training on the PyTorch port (counterpart of
examples/train_small_moe.py, with its arguments): a small MoE for a few
hundred steps with checkpoints and auto-resume (kill and re-run to see
it pick up from the last checkpoint). Exits 1 unless the loss falls.
Runs on the GPU unless `--device cpu` is given; any other argument of
repro_torch.launch.train may follow and overrides the example's (e.g.
`--steps 40 --ckpt-dir DIR`).

  PYTHONPATH=src python examples/train_small_moe_torch.py
  PYTHONPATH=src python examples/train_small_moe_torch.py --device cpu
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    losses = main([
        "--arch", "granite-moe-1b-a400m",
        "--smoke",
        "--steps", "200",
        "--batch", "8",
        "--seq", "64",
        "--lr", "1e-3",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_moe_ckpt"),
        "--ckpt-every", "50",
        "--log-every", "20",
        *sys.argv[1:],
    ])
    ok = losses[-1] < losses[0]
    print("loss decreased:", ok)
    sys.exit(0 if ok else 1)
