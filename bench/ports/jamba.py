"""The port's configuration of a Jamba family file: Mamba mixers with one
attention layer a period, routed experts every other layer."""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig


def port_config(dims, common: dict) -> ModelConfig:
    return ModelConfig(
        **common, family="hybrid",
        moe=MoEConfig(n_experts=dims.n_experts, top_k=dims.top_k, d_expert=dims.d_expert,
                      layer_pattern="every_2"),
        mamba=MambaConfig(d_state=dims.d_state, d_conv=dims.d_conv, expand=dims.expand,
                          dt_rank=dims.dt_rank),
        attn_every=dims.attn_period, subquadratic=True)
