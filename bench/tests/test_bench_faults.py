"""A whole run with the chip check skipped, at tiny sizes on the CPU: sound
runs come out correct; with the timed path broken underneath (each
decoded token replaced by the next id, where the engine produces it) the
check comes out false. Also drives a traced run's instruments."""
import json
import time

import pytest

import tiny
from harness import run_cell

from repro_torch.serving.engine import TriMoEServingEngine


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


def next_token_fault(monkeypatch):
    """Every decoded token replaced by the next id where the engine
    produces it: each decode step's logits rolled by one over the
    vocabulary."""
    step = TriMoEServingEngine.step_slots_paged

    def broken(self, *a, **kw):
        logits, counts = step(self, *a, **kw)
        return logits.roll(1, dims=-1), counts

    monkeypatch.setattr(TriMoEServingEngine, "step_slots_paged", broken)


@pytest.mark.parametrize("cell", ["tiny-deepseek.chat", "tiny-jamba.chat"])
@pytest.mark.parametrize("fault", [None, "token"])
def test_correct_only_without_the_fault(bench_dir, cell, fault, monkeypatch):
    if fault == "token":
        next_token_fault(monkeypatch)
    out = run_cell(bench_dir, cell, 2**31 + 5, 4.0, False, time.time(), device="cpu")
    assert out["correct"] is (fault is None), out["checks"]
    assert out["checks"]["tokens_compared"]["value"] >= tiny.LIMITS["min_tokens_compared"]
    assert list(out)[-1] == "checks"
    e2e = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())["end_to_end"]
    assert set(out["metrics"]) == {m["name"] for m in e2e}


def test_traced_run_reports_per_layer_metrics(bench_dir):
    out = run_cell(bench_dir, "tiny-deepseek.chat", 11, 2.0, True, time.time(), device="cpu")
    assert out["correct"]
    # no card: every device-trace reading is absent, the host's and the counters' are there
    assert {"step_ms_p50", "decode_rows_mean", "ttft_p95_s", "migrations_per_step",
            "prefix_hit_rate", "experts_touched_per_step"} <= set(out["metrics"])
    assert not {"device_idle_pct", "expert_gemv_roofline", "moe_gemm_roofline",
                "step_mfu"} & set(out["metrics"])
