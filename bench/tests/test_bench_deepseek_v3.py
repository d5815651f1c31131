"""The DeepSeek-V3 configuration in the benchmark: its file read into the
dimensions of one chip's share, the router bias's reach at the cell's
widths, its FLOPs by hand, `held_pick_pct` on spans and on a tiny cell run
through the harness on the CPU (the program within its limit, the float8
control over it)."""
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tiny
import roofline
import system
from harness import load_cell, run_cell
from reference import deepseek_v3 as ref
from spec import dims_of, module_at
from weights import draw, layer_spec

READ = module_at(tiny.BENCH / "metrics" / "held_pick_pct.py").read
CELL = load_cell(tiny.BENCH, "deepseek-v3.chat")
DIMS = dims_of(CELL["model"])
TINY = {
    "name": "tiny-v3", "model_type": "deepseek_v3", "num_hidden_layers": 3,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 96, "vocab_size": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "q_lora_rank": 24,
    "n_routed_experts": 16, "num_experts_per_tok": 4, "moe_intermediate_size": 32,
    "n_shared_experts": 1, "norm_topk_prob": True, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "n_group": 4,
    "topk_group": 2, "topk_method": "noaux_tc", "scoring_func": "sigmoid",
    "routed_scaling_factor": 2.5, "num_nextn_predict_layers": 1,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1},
    "held_experts": {"first": 4, "count": 4}, "runs_as": {"num_nextn_predict_layers": 0},
    "served_dtype": "float32",
}


def test_the_file_reads_as_one_chip_of_four():
    cfg = CELL["model"]
    assert cfg["n_routed_experts"] == 256 and cfg["published"] == {"num_hidden_layers": 61}
    share = cfg["held_experts"]
    assert share["count"] * share["chips_per_layer"] == cfg["n_routed_experts"]
    assert (DIMS.n_experts, DIMS.n_routed, DIMS.held_from, DIMS.top_k) == (64, 256, 0, 8)
    assert DIMS.sigs == (("mla", "dense"),) * 3 + (("mla", "moe"),) * 4
    assert DIMS.yarn == (40.0, 4096, 32.0, 1.0, 1.0, 1.0)
    assert sum(CELL["workload"]["loop"]["sizes"]) == DIMS.n_experts
    pc = system.port_config(DIMS)
    mo = pc.moe
    assert (mo.n_experts, mo.routed, mo.held_from, mo.router) == (64, 256, 0, "noaux_tc")
    assert (mo.n_group, mo.topk_group, mo.routed_scale, mo.first_k_dense) == (8, 4, 2.5, 3)
    assert pc.mla.q_lora_rank == 1536 and pc.mla.kv_norm and pc.mla.yarn.factor == 40
    with pytest.raises(ValueError, match="multi-token"):
        dims_of({**cfg, "runs_as": {}})


def test_router_bias_changes_top8_choices_at_the_cells_widths():
    leaves = layer_spec(DIMS, 3)  # only the router's two leaves, not the experts'
    w = {k: draw(DIMS, 2**31 + 77, 3, k, leaves[k], "cpu") for k in ("ffn.router",
                                                                      "ffn.router_bias")}
    assert w["ffn.router"].shape == (7168, 256) and w["ffn.router_bias"].shape == (256,)
    x = torch.randn(256, 7168, generator=torch.Generator().manual_seed(0))
    logits = x @ w["ffn.router"]
    _, with_bias = ref.routing(logits, w["ffn.router_bias"], DIMS)
    _, without = ref.routing(logits, torch.zeros(256), DIMS)
    changed = sum(set(a.tolist()) != set(b.tolist()) for a, b in zip(with_bias, without))
    assert 0.1 * 256 < changed < 256  # some tokens' picks move, not every token's


def test_layer_flops_by_hand():
    d, h, ql, r = 7168, 128, 1536, 512
    mla = 2 * (d * ql + ql * h * 192 + d * (r + 64) + r * h * 256 + h * 128 * d)
    per_key = 2 * h * (192 + 128)
    dense = 6 * d * 18432
    moe = 2 * d * 256 + 6 * d * 2048 * (8 * 64 / 256 + 1)
    assert roofline.layer_token_flops(DIMS, 0, 100) == mla + per_key * 100 + dense
    assert roofline.layer_token_flops(DIMS, 5, 100) == mla + per_key * 100 + moe
    assert roofline.token_flops(DIMS, 0) == 7 * mla + 3 * dense + 4 * moe


def span(name, ts, dur, **args):
    ev = {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "pid": 1, "tid": 1}
    if args:
        ev["args"] = args
    return ev


@pytest.fixture
def program(monkeypatch):
    import program_trace

    def install(evs):
        monkeypatch.setattr(program_trace, "program_events", lambda: evs)
        monkeypatch.setattr(module_at(tiny.BENCH / "metrics" / "held_pick_pct.py"),
                            "program_events", lambda: evs)
    return install


def test_held_pick_pct_reads_the_window_growth(program):
    us = 1e6
    program([
        span("step", 5 * us, us), span("decode", 5.1 * us, us, held_picks=10, routed_picks=64),
        span("step", 12 * us, us), span("decode", 12.1 * us, us, held_picks=100,
                                        routed_picks=320),
        span("decode", 15 * us, us, held_picks=170, routed_picks=576, profiled=True),
        span("step", 19 * us, us), span("decode", 19.1 * us, us, held_picks=260,
                                        routed_picks=832),
    ])
    # the window's decode spans (from 10 s on): (260 - 100) / (832 - 320)
    assert READ(SimpleNamespace(window_s=10.0)) == pytest.approx(100.0 * 160 / 512)
    program([span("step", 5 * us, us), span("decode", 5.1 * us, us, rows=4, live=4)])
    assert READ(SimpleNamespace(window_s=10.0)) is None  # a program without the counters
    program(None)
    assert READ(SimpleNamespace(window_s=10.0)) is None


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"), configs=(TINY,))


@pytest.mark.parametrize("seed", [2**31 + 3, 41])
def test_tiny_cell_within_its_limit_and_the_control_over_it(bench_dir, seed):
    out = run_cell(bench_dir, "tiny-v3.chat", seed, 3.0, True, time.time(), device="cpu",
                   control=True)
    limit = out["checks"]["mean_logit_gap"]["limit"]
    assert out["checks"]["mean_logit_gap"]["value"] <= limit
    assert out["diagnostics"]["control_mean_logit_gap"] > limit
    held = out["metrics"]["held_pick_pct"]["value"]
    # 4 of 16 experts held: near a quarter of the picks
    assert 5.0 < held < 60.0 and not math.isnan(held)


def test_held_pick_pct_equals_the_calls_counts(bench_dir, monkeypatch):
    """The loop's totals against the harness's own record of the decode MoE
    calls, step by step: each step's growth of `held_picks` is its calls'
    counts summed, of `routed_picks` top_k x MoE layers x its live rows; and
    the metric is that growth's share over a run of steps."""
    import harness
    import program_trace

    seen = {}
    orig_record, orig_tracing = harness.Record, harness.Tracing

    def keep_record(*a, **kw):
        seen["events"] = list(program_trace.program_events() or [])
        return orig_record(*a, **kw)

    def keep_tracing(*a, **kw):
        seen["tracing"] = orig_tracing(*a, **kw)
        return seen["tracing"]

    monkeypatch.setattr(harness, "Record", keep_record)
    monkeypatch.setattr(harness, "Tracing", keep_tracing)
    out = run_cell(bench_dir, "tiny-v3.chat", 7, 3.0, True, time.time(), device="cpu")
    tracing = seen["tracing"]
    picks = TINY["num_experts_per_tok"] * (TINY["num_hidden_layers"]
                                            - TINY["first_k_dense_replace"])
    calls = [c for d, c, _ in tracing.moe if d]
    per = len(calls) // len(tracing.decode_rows)
    assert per == TINY["num_hidden_layers"] - TINY["first_k_dense_replace"]
    assert all(np.asarray(c.cpu()).shape == (4,) for _, c, _ in tracing.moe)
    # the harness's steps: (held picks, routed picks)
    want = [(sum(int(c.sum()) for c in calls[i * per:(i + 1) * per]), picks * len(rows))
            for i, (rows, _) in enumerate(tracing.decode_rows)]
    marks = sorted((e for e in seen["events"] if e.get("ph") == "X" and e["name"] == "decode"
                    and "held_picks" in e.get("args", {})), key=lambda e: e["ts"])
    tot = [(e["args"]["held_picks"], e["args"]["routed_picks"]) for e in marks]
    # the counters' steps: a step's counts are observed in the next step
    got = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(tot, tot[1:])]
    # the harness saw the window's steps in a row; the last one's counts may
    # be observed after the run's last decode span
    at = [o for o in range(len(got)) if got[o:o + len(want)] == want[:len(got) - o]]
    assert len(want) >= 2 and at and len(got) - at[0] >= 1
    assert any(v[0] for v in want)  # some picks went to the experts held
    held = out["metrics"]["held_pick_pct"]["value"]
    shares = [100.0 * (b[0] - a[0]) / (b[1] - a[1])
              for i, a in enumerate(tot) for b in tot[i + 1:] if b[1] > a[1]]
    assert any(held == pytest.approx(v, rel=1e-12) for v in shares)
