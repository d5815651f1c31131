"""The port's examples and its trace exporter run on the CPU, each in a
fresh interpreter that refuses to import `jax` or anything of the JAX
package `repro`: examples/quickstart_torch.py (llama3.2-3b smoke: 10
AdamW steps, prefill, 8 decode steps), serve_moe_offload_torch.py,
train_small_moe_torch.py (a shorter run: the loss must still fall, or
it exits 1) and tools/export_trace_torch.py. The exporter's trace passes
its own `--check` (which imports no torch) and the reference's
tools/export_trace.py `--check` (which imports no JAX), and both reject
a trace without the required families.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.models.model import resolve_device

ROOT = Path(__file__).resolve().parents[1]
# a meta-path finder that fails every import of the named top-level
# packages, then runs the script as __main__ with the given arguments
RUNNER = """
import runpy, sys
BLOCKED = set(sys.argv[1].split(","))
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} may not be imported here")
sys.meta_path.insert(0, Refuse())
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
NO_JAX = "jax,jaxlib,repro"


def _run(script, *args, blocked=NO_JAX, cwd=None, timeout=300):
    # one intra-op thread: beside the suite's other workers, a process
    # that spins a thread per core slows every one of them many times over
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", RUNNER, blocked, str(ROOT / script),
                           *map(str, args)], cwd=cwd or ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _ok(proc):
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_runs_on_the_cpu_without_jax():
    out = _ok(_run("examples/quickstart_torch.py", "--device", "cpu"))
    assert "device=cpu" in out
    assert sum(line.startswith("step ") for line in out.splitlines()) == 10
    ids = json.loads(out.split("generated token ids:")[1].strip())
    assert len(ids) == 8 and all(0 <= t < 256 for t in ids)


def test_serve_example_runs_on_the_cpu_without_jax():
    out = _ok(_run("examples/serve_moe_offload_torch.py", "--device", "cpu"))
    assert "[serve] device=cpu 8/8 requests, 128 tokens" in out


def test_train_example_runs_on_the_cpu_without_jax(tmp_path):
    out = _ok(_run("examples/train_small_moe_torch.py", "--device", "cpu", "--steps", 30,
                   "--ckpt-dir", tmp_path / "ckpt", "--ckpt-every", 20, "--log-every", 10))
    assert "loss decreased: True" in out
    assert any((tmp_path / "ckpt").iterdir())  # the step-20 checkpoint


def test_exporter_runs_and_its_trace_passes_both_checks(tmp_path):
    out = _ok(_run("tools/export_trace_torch.py", "--device", "cpu", cwd=tmp_path))
    assert "served 8/8" in out and "ok: serving.trace.json" in out
    for name in ("serving.trace.json", "metrics_snapshot.json", "metrics_snapshot.prom"):
        assert (tmp_path / name).stat().st_size > 0
    events = json.loads((tmp_path / "serving.trace.json").read_text())["traceEvents"]
    kernel = {e["name"] for e in events if e["name"].startswith("kernel.")}
    assert kernel == {"kernel.paged_prefill_gqa", "kernel.paged_decode_gqa",
                      "kernel.grouped_expert_ffn", "kernel.cold_expert_ffn"}
    assert {e["args"]["backend"] for e in events if e["name"] in kernel} == {"ref"}
    snap = json.loads((tmp_path / "metrics_snapshot.json").read_text())
    assert snap["serving.completed"] == 8 and snap["engine.migrations"] > 0
    trace = tmp_path / "serving.trace.json"
    # its own check imports no torch; the reference's imports no JAX
    _ok(_run("tools/export_trace_torch.py", "--check", trace, blocked="torch,jax,repro"))
    _ok(_run("tools/export_trace.py", "--check", trace, blocked="jax,jaxlib,repro_torch"))


@pytest.mark.parametrize("script,blocked", [
    ("tools/export_trace_torch.py", "torch,jax,repro"),
    ("tools/export_trace.py", "jax,jaxlib,repro_torch"),
])
def test_trace_checks_reject_a_trace_without_the_families(tmp_path, script, blocked):
    bad = tmp_path / "bad.trace.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "step", "ph": "X", "ts": 0, "dur": 5, "pid": 1, "tid": 1}]}))
    proc = _run(script, "--check", bad, blocked=blocked)
    assert proc.returncode == 1
    assert "missing required span family 'decode'" in proc.stdout


def test_a_card_without_an_index_is_the_current_one(monkeypatch):
    """The entry points name no card: the loop must see the device its
    params were made on (`cuda:0`), not a bare "cuda", which compares
    unequal to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
