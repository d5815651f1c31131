"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536. Attention appears once per 8-layer block (attn_every=8);
MoE replaces the dense FFN on every other layer (every_2).
Hybrid => sub-quadratic: long_500k runs (Mamba state + 4 seq-sharded
attention KV caches).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, layer_pattern="every_2"),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    subquadratic=True,
)
