"""qwen3-235b-a22b — paper Table 2 simulator workload (not an assigned arch).

[arXiv:2505.09388] 94L d_model=4096 64H (GQA kv=4), MoE 128 routed
experts top-8, no shared experts, expert hidden 1536. 423 GB expert
weights. Used by the TriMoE simulator benchmarks (Fig. 6/7, robustness).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536, n_shared=0,
                  layer_pattern="all"),
)
