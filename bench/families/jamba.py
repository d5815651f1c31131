"""Jamba: one GQA attention layer every `attn_layer_period` layers (at
`attn_layer_offset`), Mamba mixers elsewhere; routed experts every
`expert_layer_period` layers (at `expert_layer_offset`), dense SwiGLU
elsewhere. Read from a configuration file's keys as the published
`config.json` has them; the attention layer takes RoPE only where the
file gives `attention_rope_theta`, and Mamba's dt, B and C norms
(`mamba_dt_bc_norm`, true in the published model) are refused: the
benchmark's reference does not compute them."""
from spec import Dims, common_dims


def dims_of(cfg: dict) -> Dims:
    n, d = int(cfg["num_hidden_layers"]), int(cfg["hidden_size"])
    if cfg.get("mamba_dt_bc_norm", True):
        raise ValueError("the benchmark's Mamba mixer has no norms on dt, B and C")
    if "attention_rope_theta" not in cfg:
        raise ValueError("attention without positions is not understood: "
                         "give attention_rope_theta")
    ap, ao = int(cfg["attn_layer_period"]), int(cfg["attn_layer_offset"])
    ep, eo = int(cfg["expert_layer_period"]), int(cfg["expert_layer_offset"])
    return Dims(
        **common_dims(cfg), head_dim=d // int(cfg["num_attention_heads"]),
        rope_theta=float(cfg["attention_rope_theta"]),
        sigs=tuple(("attn" if i % ap == ao else "mamba", "moe" if i % ep == eo else "dense")
                   for i in range(n)),
        n_experts=int(cfg["num_experts"]), top_k=int(cfg["num_experts_per_tok"]),
        d_expert=int(cfg["intermediate_size"]), n_shared=0,
        d_state=int(cfg["mamba_d_state"]), d_conv=int(cfg["mamba_d_conv"]),
        expand=int(cfg["mamba_expand"]), dt_rank=int(cfg["mamba_dt_rank"]),
        attn_period=ap,
    )
