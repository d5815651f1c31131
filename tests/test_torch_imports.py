"""The PyTorch port stands alone: importing every module of
`repro_torch`, and everything chip_smoke.py imports, loads neither JAX
nor any module of the JAX package `repro` (the machine with the card
has no JAX)."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, ".")
importlib.import_module("chip_smoke")
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "forbidden": loaded}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    # the walk really covered the slice's modules
    for mod in ("repro_torch.serving.loop", "repro_torch.kernels.moe_gemm.kernel",
                "repro_torch.kernels.expert_gemv.ops", "repro_torch.launch.serve",
                "repro_torch.bridge", "repro_torch.obs.trace"):
        assert mod in res["modules"]
