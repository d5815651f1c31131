"""The PyTorch port stands alone: importing every module of
`repro_torch`, everything chip_smoke.py imports, and the port's entry
points outside the package (the `*_torch.py` examples, the trace
exporter, the chip probes) loads neither JAX nor any module of the JAX
package `repro` (the machine with the card has no JAX)."""
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
import importlib.util
for i, path in enumerate(ENTRY_FILES):  # loaded as modules: their main does not run
    spec = importlib.util.spec_from_file_location(f"_entry{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "forbidden": loaded}))
"""


# the port's entry points outside src/repro_torch
ENTRY_FILES = ["examples/quickstart_torch.py", "examples/serve_moe_offload_torch.py",
               "examples/train_small_moe_torch.py", "examples/simulate_paper_torch.py",
               "tools/export_trace_torch.py", "tools/train_probe.py",
               "tools/dist_probe.py", "tools/gemv_probe.py", "tools/mla_probe.py",
               "tools/serve_pair.py", "tools/mesh_train_probe.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    probe = f"ENTRY_FILES = {ENTRY_FILES!r}\n" + PROBE
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    # the walk really covered the slice's modules
    for mod in ("repro_torch.serving.loop", "repro_torch.kernels.moe_gemm.kernel",
                "repro_torch.kernels.expert_gemv.ops", "repro_torch.launch.serve",
                "repro_torch.bridge", "repro_torch.obs.trace",
                "repro_torch.kernels.flash_attention.kernel",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.kernels.paged_attention.kernel",
                "repro_torch.models.attention", "repro_torch.serving.kv_cache",
                "repro_torch.models.mamba", "repro_torch.models.xlstm",
                "repro_torch.models.moe", "repro_torch.kernels.moe_gemm.ops",
                "repro_torch.training.optimizer", "repro_torch.training.train_step",
                "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpoint",
                "repro_torch.distributed.fault_tolerance", "repro_torch.launch.train",
                "repro_torch.tree", "repro_torch.core.scheduler",
                "repro_torch.core.relayout", "repro_torch.core.simulator",
                "repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
                "repro_torch.launch.mesh", "repro_torch.launch.dryrun"):
        assert mod in res["modules"]


EXAMPLE = r"""
import json, runpy, sys
sys.argv = ["simulate_paper_torch.py", "--batch", "64", "--steps", "1"]
runpy.run_path("examples/simulate_paper_torch.py", run_name="__main__")
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"forbidden": loaded}))
"""


def test_simulate_paper_example_imports_no_jax_and_nothing_of_repro():
    """The port-side example runs (a short cell) on `repro_torch` alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", EXAMPLE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1])["forbidden"] == []
    assert any("TriMoE decode speedup vs best baseline" in line for line in lines)
