"""The port's configuration of a DeepSeek-V3 family file: q-LoRA MLA with
the latent norms and YaRN in every layer, dense FFNs in the leading
layers, then the noaux_tc router over every routed expert, the experts
held here and the shared ones."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, YarnScaling


def port_config(dims, common: dict) -> ModelConfig:
    factor, n_ctx, beta_fast, beta_slow, mscale, mscale_all_dim = dims.yarn
    return ModelConfig(
        **common, family="moe",
        moe=MoEConfig(n_experts=dims.n_experts, top_k=dims.top_k, d_expert=dims.d_expert,
                      n_shared=dims.n_shared, layer_pattern="first_k_dense",
                      first_k_dense=dims.first_dense, router="noaux_tc", n_group=dims.n_group,
                      topk_group=dims.topk_group, routed_scale=dims.routed_scale,
                      n_routed=dims.n_routed, held_from=dims.held_from),
        mla=MLAConfig(kv_lora_rank=dims.kv_lora_rank, qk_nope_head_dim=dims.qk_nope_head_dim,
                      qk_rope_head_dim=dims.qk_rope_head_dim, v_head_dim=dims.v_head_dim,
                      q_lora_rank=dims.q_lora_rank, kv_norm=True,
                      yarn=YarnScaling(factor=factor, original_max_position_embeddings=n_ctx,
                                       beta_fast=beta_fast, beta_slow=beta_slow,
                                       mscale=mscale, mscale_all_dim=mscale_all_dim)))
