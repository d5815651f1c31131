"""deepseek-v2-236b [moe] — MLA + fine-grained MoE; the paper's flagship.

[arXiv:2405.04434; hf] 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160 routed experts top-6 + 2 shared experts,
MLA kv_lora_rank=512 (cache = 512 latent + 64 rope = 576/token).
First layer keeps a dense FFN (d_ff=12288) per the released model;
MoE on layers 1..59 ("all_but_first").

This is TriMoE's primary workload (paper Table 2 row 1): 422 GB of expert
weights, 2 shared (always-hot) + 160 routed experts from which the
hot/warm/cold tiers are scheduled.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,  # dense FFN on layer 0 only
    vocab_size=102400,
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_expert=1536,
        n_shared=2,
        layer_pattern="all_but_first",
    ),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
)
