"""granite-moe-1b-a400m [moe] — 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H
(GQA kv=8) d_ff(expert)=512 vocab=49155, MoE 32e top-8. Every layer MoE,
no shared experts. Small-expert regime: stresses the cold/NDP tier
(many low-load experts, localized layout).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,  # all layers MoE
    vocab_size=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512, layer_pattern="all"),
)
