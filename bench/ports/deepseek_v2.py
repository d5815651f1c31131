"""The port's configuration of a DeepSeek-V2 family file: MLA in every
layer, routed plus shared experts after the first dense layer."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def port_config(dims, common: dict) -> ModelConfig:
    return ModelConfig(
        **common, family="moe",
        moe=MoEConfig(n_experts=dims.n_experts, top_k=dims.top_k, d_expert=dims.d_expert,
                      n_shared=dims.n_shared, layer_pattern="all_but_first"),
        mla=MLAConfig(kv_lora_rank=dims.kv_lora_rank, qk_nope_head_dim=dims.qk_nope_head_dim,
                      qk_rope_head_dim=dims.qk_rope_head_dim, v_head_dim=dims.v_head_dim))
