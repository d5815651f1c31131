"""glm-4.5-air — paper Table 2 simulator workload (not an assigned arch).

[arXiv:2508.06471] 46L d_model=4096 96H (GQA kv=8), MoE 128 routed
experts top-8 + 1 shared, expert hidden 1408. 190 GB expert weights.
Used by the TriMoE simulator benchmarks (Fig. 6/7, ablation).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="glm-4.5-air",
    family="moe",
    n_layers=46,
    d_model=4096,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=151552,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1408, n_shared=1,
                  layer_pattern="all"),
)
