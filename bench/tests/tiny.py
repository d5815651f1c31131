"""Tiny cells for the CPU tests: the same harness, reference and readers
as the benchmark's cells, on configurations and a mix small enough for a
test run. `make_root` writes a checkout-like directory (BENCHMARK.json
beside a bench/ folder of configs, workloads, traffic, arrival processes
and metrics) that the harness reads by name, as it reads the real one;
model families and their ports are found beside `spec.py`."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

DEEPSEEK = {
    "name": "tiny-deepseek", "model_type": "deepseek_v2", "num_hidden_layers": 3,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 96, "vocab_size": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "q_lora_rank": None,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
    "n_shared_experts": 1, "norm_topk_prob": True, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "served_dtype": "float32",
}
JAMBA = {
    "name": "tiny-jamba", "model_type": "jamba", "num_hidden_layers": 4,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 48, "vocab_size": 256, "rms_norm_eps": 1e-6,
    "attention_rope_theta": 10000, "mamba_dt_bc_norm": False, "attn_layer_period": 4, "attn_layer_offset": 2,
    "expert_layer_period": 2, "expert_layer_offset": 1, "num_experts": 4,
    "num_experts_per_tok": 2, "norm_topk_prob": True, "mamba_d_state": 4,
    "mamba_d_conv": 4, "mamba_expand": 2, "mamba_dt_rank": 4, "served_dtype": "float32",
}
MIX = {"generator": "chat", "system_prompts": {"count": 2, "tokens": 8, "zipf": 1.2},
       "user_tokens": {"min": 4, "max": 20, "median": 8, "sigma": 0.5},
       "output_tokens": {"min": 4, "max": 12, "median": 8, "sigma": 0.3},
       "token_zipf": 1.2, "phase_requests": 8, "block": 16, "size_seed": 3,
       "arrivals": {"process": "exp_quantiles", "block": 8}}
LOOP = {"batch_size": 4, "n_groups": 2, "cache_len": 64, "prefill_chunk_tokens": 16}
LIMITS = {"mean_logit_gap": 1e-4, "min_tokens_compared": 8}


def make_root(tmp: Path, configs=(DEEPSEEK, JAMBA), dtype: str = "float32",
              limits=LIMITS) -> Path:
    """A directory the harness reads as it reads the checkout: one chat
    cell "<config>.chat" per configuration. Returns its bench/ folder."""
    bench_dir = tmp / "bench"
    for sub in ("configs", "workloads"):
        (bench_dir / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "traffic", "arrivals"):
        shutil.copytree(BENCH / sub, bench_dir / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = {**real, "configs": [], "workloads": []}
    (bench_dir / "traffic" / "tiny_chat.json").write_text(json.dumps(MIX))
    for cfg in configs:
        name = cfg["name"]
        (bench_dir / "configs" / f"{name}.json").write_text(
            json.dumps({**cfg, "served_dtype": dtype}))
        bench["configs"].append({"name": name, "source": "tiny", "file":
                                 f"bench/configs/{name}.json", "reduced": [], "why": "test"})
        cell = f"{name}.chat"
        bench["workloads"].append({"name": cell, "config": name, "traffic": "tiny_chat",
                                   "chips": 1, "why": "test"})
        (bench_dir / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"loop": LOOP, "load": {"clients": 4}, "limits": limits}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir
