"""DeepSeek-V3: MLA with a low-rank q path (q_lora_rank) and RMSNorm on
both latents, YaRN on the rope dims, a dense SwiGLU FFN in the first
`first_k_dense_replace` layers, then routed experts under the `noaux_tc`
router (sigmoid scores, a bias-corrected top-k within the best groups,
weights renormalized and scaled) plus shared experts. Read from a
configuration file's keys as the published `config.json` has them.

A file may hold a share of each MoE layer's experts, as one chip of an
expert-parallel deployment does: `held_experts` {"first", "count"} of the
`n_routed_experts` the router scores. The router keeps its published
width and top-k; `Dims.n_experts` is the count held, and the reference
and the program both add only the held experts' part. The
multi-token-prediction module is refused: the served model does not run
it (a file states `num_nextn_predict_layers` 0 under `runs_as`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from reference import deepseek_v3 as ref
from spec import Dims, common_dims
from weights import Leaf, _proj, dense_leaves, moe_leaves


@dataclasses.dataclass(frozen=True)
class V3Dims(Dims):
    q_lora_rank: int = 0
    n_routed: int = 0  # the router's width: every routed expert
    held_from: int = 0  # the first expert held here
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    first_dense: int = 0
    # (factor, original context, beta_fast, beta_slow, mscale, mscale_all_dim)
    yarn: tuple = (1.0, 1, 32.0, 1.0, 1.0, 1.0)


def dims_of(cfg: dict) -> V3Dims:
    n = int(cfg["num_hidden_layers"])
    if int(cfg.get("num_nextn_predict_layers", 0)):
        raise ValueError("the served model runs no multi-token-prediction module")
    if cfg.get("topk_method") != "noaux_tc" or cfg.get("scoring_func") != "sigmoid":
        raise ValueError("only the noaux_tc router over sigmoid scores is understood")
    if int(cfg["moe_layer_freq"]) != 1:
        raise ValueError("moe_layer_freq other than 1 is not understood")
    rs = cfg["rope_scaling"]
    if rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs.get('type')!r} is not understood")
    routed = int(cfg["n_routed_experts"])
    share = cfg.get("held_experts", {"first": 0, "count": routed})
    first, count = int(share["first"]), int(share["count"])
    if not (0 <= first and first + count <= routed and count >= 1):
        raise ValueError(f"held experts {first}..{first + count - 1} of {routed}")
    dense = int(cfg["first_k_dense_replace"])
    return V3Dims(
        **common_dims(cfg), head_dim=0, rope_theta=float(cfg["rope_theta"]),
        sigs=tuple(("mla", "dense" if i < dense else "moe") for i in range(n)),
        n_experts=count, top_k=int(cfg["num_experts_per_tok"]),
        d_expert=int(cfg["moe_intermediate_size"]), n_shared=int(cfg["n_shared_experts"]),
        kv_lora_rank=int(cfg["kv_lora_rank"]), qk_nope_head_dim=int(cfg["qk_nope_head_dim"]),
        qk_rope_head_dim=int(cfg["qk_rope_head_dim"]), v_head_dim=int(cfg["v_head_dim"]),
        q_lora_rank=int(cfg["q_lora_rank"]), n_routed=routed, held_from=first,
        n_group=int(cfg["n_group"]), topk_group=int(cfg["topk_group"]),
        routed_scale=float(cfg["routed_scaling_factor"]), first_dense=dense,
        yarn=(float(rs["factor"]), int(rs["original_max_position_embeddings"]),
              float(rs["beta_fast"]), float(rs["beta_slow"]), float(rs["mscale"]),
              float(rs["mscale_all_dim"])),
    )


# the router bias's spread: enough that it changes some top-k choices (the
# scores near the top-8 boundary lie a few hundredths apart)
ROUTER_BIAS_STD = 0.02


def layer_spec(dims: V3Dims, i: int) -> Dict[str, Leaf]:
    """Layer `i`'s leaves by their path in the program's tree: the norms,
    MLA with the q path and the latent norm, then the dense FFN or the
    router over every routed expert with its bias, the held experts and
    the shared ones."""
    d, h, r, rd = dims.d_model, dims.n_heads, dims.kv_lora_rank, dims.qk_rope_head_dim
    nope, v, ql = dims.qk_nope_head_dim, dims.v_head_dim, dims.q_lora_rank
    norm = ((d,), "param", ("around", 1.0, 0.1))
    out = {
        "norm1.scale": norm,
        "mixer.wq_a": _proj((d, ql), d),
        "mixer.q_norm.scale": ((ql,), "param", ("around", 1.0, 0.1)),
        "mixer.wq_b": _proj((ql, h, nope + rd), ql),
        "mixer.wkv_a": _proj((d, r + rd), d),
        "mixer.kv_norm.scale": ((r,), "param", ("around", 1.0, 0.1)),
        "mixer.wkv_b": _proj((r, h, nope + v), r),
        "mixer.wo": _proj((h, v, d), h * v),
        "norm2.scale": norm,
    }
    if dims.sigs[i][1] == "dense":
        return {**out, **dense_leaves(dims)}
    out.update(moe_leaves(dims))
    out["ffn.router"] = ((d, dims.n_routed), "f32", ("normal", d ** -0.5))
    out["ffn.router_bias"] = ((dims.n_routed,), "f32", ("around", 0.0, ROUTER_BIAS_STD))
    return out


def reference_layer(w, x, dims: V3Dims, i: int, quant):
    return ref.block(w, x, dims, i, quant)


def layer_token_flops(dims: V3Dims, i: int, ctx: int) -> int:
    """Model FLOPs of layer `i` for one token over `ctx` keys: MLA with its
    q path (q_a, q_b), the latent down- and up-projections and wo, scores
    and values; the dense FFN, or the router at its whole width, the
    routed experts at the share picked here (top-k x held / routed) and
    the shared experts."""
    d, h, r, rd = dims.d_model, dims.n_heads, dims.kv_lora_rank, dims.qk_rope_head_dim
    nope, v, ql = dims.qk_nope_head_dim, dims.v_head_dim, dims.q_lora_rank
    f = 2 * (d * ql + ql * h * (nope + rd) + d * (r + rd) + r * h * (nope + v) + h * v * d)
    f += 2 * ctx * h * (nope + rd + v)
    if dims.sigs[i][1] == "dense":
        return f + 6 * d * dims.d_ff
    picked = dims.top_k * dims.n_experts / dims.n_routed
    return int(f + 2 * d * dims.n_routed + 6 * d * dims.d_expert * (picked + dims.n_shared))
