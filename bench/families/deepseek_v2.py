"""DeepSeek-V2: latent attention (MLA) in every layer, a dense SwiGLU FFN
in the first `first_k_dense_replace` layers, routed experts plus shared
experts after them. Read from a configuration file's keys as the
published `config.json` has them. What the benchmark's reference does not
compute is refused here: a low-rank q projection (`q_lora_rank`), YaRN
(`rope_scaling` of another type than "default"), group-limited routing,
a routed scaling factor other than 1."""
from spec import Dims, common_dims


def dims_of(cfg: dict) -> Dims:
    n = int(cfg["num_hidden_layers"])
    if cfg.get("q_lora_rank") is not None:
        raise ValueError("the benchmark's MLA has a direct q projection (q_lora_rank null)")
    scaling = cfg.get("rope_scaling") or {"type": "default"}
    if scaling.get("type") != "default":
        raise ValueError(f"rope_scaling {scaling.get('type')!r} is not understood")
    if int(cfg["moe_layer_freq"]) != 1:
        raise ValueError("moe_layer_freq other than 1 is not understood")
    if cfg.get("topk_method", "greedy") != "greedy" or float(
            cfg.get("routed_scaling_factor", 1)) != 1.0:
        raise ValueError("only greedy top-k routing with a routed scaling factor of 1")
    dense = int(cfg["first_k_dense_replace"])
    return Dims(
        **common_dims(cfg), head_dim=0, rope_theta=float(cfg["rope_theta"]),
        sigs=tuple(("mla", "dense" if i < dense else "moe") for i in range(n)),
        n_experts=int(cfg["n_routed_experts"]), top_k=int(cfg["num_experts_per_tok"]),
        d_expert=int(cfg["moe_intermediate_size"]), n_shared=int(cfg["n_shared_experts"]),
        kv_lora_rank=int(cfg["kv_lora_rank"]), qk_nope_head_dim=int(cfg["qk_nope_head_dim"]),
        qk_rope_head_dim=int(cfg["qk_rope_head_dim"]), v_head_dim=int(cfg["v_head_dim"]),
    )
