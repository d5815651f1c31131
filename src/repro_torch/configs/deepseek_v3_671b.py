"""deepseek-v3-671b [moe] — q-LoRA MLA with YaRN, 256 fine-grained experts
under sigmoid, group-limited routing.

[arXiv:2412.19437; hf deepseek-ai/DeepSeek-V3 config.json] 61L d_model=7168
128H, MLA q_lora_rank=1536 kv_lora_rank=512 (RMSNorm on both latents),
nope 128 + rope 64, v 128; YaRN factor 40 over 4096 original positions
(beta_fast 32, beta_slow 1, mscale = mscale_all_dim = 1: the softmax scale
times (0.1 ln 40 + 1)^2). Dense SwiGLU (d_ff=18432) in the first 3
layers, then 256 routed experts (d_expert=2048) top-8 plus 1 shared: the
`noaux_tc` router scores sigmoid(x W), picks the top-8 of score + bias
within the 4 best of 8 groups, and weights them by their unbiased scores
renormalized times 2.5. vocab=129280. The multi-token-prediction module
(num_nextn_predict_layers 1) is a speculative-decoding head the served
model does not run.
"""
from dataclasses import replace

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, YarnScaling

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # the dense FFN of layers 0-2
    vocab_size=129280,
    norm_eps=1e-6,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_expert=2048,
        n_shared=1,
        layer_pattern="first_k_dense",
        first_k_dense=3,
        router="noaux_tc",
        n_group=8,
        topk_group=4,
        routed_scale=2.5,
    ),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128, q_lora_rank=1536, kv_norm=True,
                  yarn=YarnScaling(factor=40.0, original_max_position_embeddings=4096,
                                   beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                                   mscale_all_dim=1.0)),
)


def reduced() -> ModelConfig:
    """The same block at smoke widths: one dense layer then two MoE layers,
    16 experts in 4 groups of 4 (2 kept), top-4, one shared expert."""
    return replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256,
        moe=replace(CONFIG.moe, n_experts=16, top_k=4, d_expert=32, first_k_dense=1,
                    n_group=4, topk_group=2),
        mla=replace(CONFIG.mla, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                    v_head_dim=16, q_lora_rank=24),
    )
