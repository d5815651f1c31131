"""TriMoE tiered serving end to end on the PyTorch port, at smoke scale
(counterpart of examples/serve_moe_offload.py, with its arguments).

Drives repro_torch.launch.serve's continuous-batching ServingLoop:
requests with staggered prompt lengths are admitted into zigzag decode
groups; the three-tier MoE (hot / warm / cold) serves every step while
the EMA predictor migrates experts between tiers in the gaps between
group steps. Runs on the GPU unless `--device cpu` is given; any other
argument of repro_torch.launch.serve may follow and overrides the
example's.

  PYTHONPATH=src python examples/serve_moe_offload_torch.py
  PYTHONPATH=src python examples/serve_moe_offload_torch.py --device cpu
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main([
        "--arch", "granite-moe-1b-a400m",
        "--smoke",
        "--requests", "8",
        "--batch", "4",
        "--groups", "2",
        "--prompt-len", "12",
        "--stagger", "3",
        "--new-tokens", "16",
        *sys.argv[1:],
    ])
