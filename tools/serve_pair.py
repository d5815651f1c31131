"""Serve tokens/s of chip_smoke.py's default serves, for comparing two
trees in one call on one card (run it from each tree's root in turns,
A B B A):

  python tools/serve_pair.py [ARCH ...]   # default: granite-moe-1b-a400m jamba-v0.1-52b

builds the kernels of the tree it runs in and serves each ARCH through
that tree's `chip_smoke.serve_full` (paged default mode, the same
traffic and weights as chip_smoke.py), printing one JSON line per serve
and the card's name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

DEPTH = {cs.JAMBA_ARCH: cs.JAMBA_LAYERS, cs.MLA_ARCH: cs.MLA_LAYERS}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the serves run on the GPU")
    archs = sys.argv[1:] or [cs.GQA_ARCH, cs.JAMBA_ARCH]
    dev = torch.device("cuda:0")
    torch.cuda.init()  # the memory statistics serve_full resets need an initialised device
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cs.build.build_all()
    for arch in archs:
        expect, forbid = next((e, f) for a, _, m, e, f in cs.SERVES if a == arch and m is None)
        line = cs.serve_full(dev, arch, DEPTH.get(arch), None, expect, forbid)
        print(json.dumps(dict(tree=ROOT.name, path=line["path"],
                              tokens_per_s=line["tokens_per_s"])), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
