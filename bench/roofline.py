"""The yardstick: the H100's published peaks, the operations and bytes of
the two expert kernels' calls, and the model FLOPs of a served token.
Written from `chip_smoke.py`'s arithmetic (its HBM_BPS, PEAK_FLOPS and the
kernel table's byte counts); imports nothing of the program.

A kernel's bound is the larger of its bytes over HBM bandwidth and its
operations over peak FLOP/s. Bytes count each input read once and each
output written once, as the inputs need them: the weights of the experts
that received at least one token, the token rows dispatched to them and
the rows they return. The intermediate activations between an expert's
gate|up and down products are the kernel's own and are not counted.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from spec import Dims, family

HBM_BPS = 3.35e12  # NVIDIA H100 SXM HBM3, data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity, no TF32
BYTES = {"bfloat16": 2, "float32": 4}


def expert_ffn_bytes(dims: Dims, live_experts: int, rows: int) -> int:
    """One expert FFN call: `live_experts` experts' gate, up and down
    matrices, `rows` dispatched token rows in and out."""
    b = BYTES[dims.dtype]
    return live_experts * 3 * dims.d_model * dims.d_expert * b + 2 * rows * dims.d_model * b


def expert_ffn_flops(dims: Dims, rows: int) -> int:
    """Three products of D x F per dispatched row, two operations a MAC."""
    return 6 * rows * dims.d_model * dims.d_expert


def bound_s(dims: Dims, flops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[dims.dtype])


def expert_call_bound_s(dims: Dims, live_experts: int, rows: int) -> float:
    return bound_s(dims, expert_ffn_flops(dims, rows), expert_ffn_bytes(dims, live_experts, rows))


def mla_token_flops(dims: Dims, ctx: int) -> int:
    """MLA in the expanded form (each token's own K/V up-projection), its
    scores and values over `ctx` keys."""
    d, h, nope, rd = dims.d_model, dims.n_heads, dims.qk_nope_head_dim, dims.qk_rope_head_dim
    r, dv = dims.kv_lora_rank, dims.v_head_dim
    f = 2 * (d * h * (nope + rd) + d * (r + rd) + r * h * (nope + dv) + h * dv * d)
    return f + 2 * ctx * h * (nope + rd + dv)


def gqa_token_flops(dims: Dims, ctx: int) -> int:
    d, h, kv, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    return 2 * (2 * d * h * hd + 2 * d * kv * hd) + 2 * ctx * h * 2 * hd


def mamba_token_flops(dims: Dims, ctx: int) -> int:
    """Projections, the depthwise conv, the scan's update and read-out."""
    d, di, n, dtr = dims.d_model, dims.d_inner, dims.d_state, dims.dt_rank
    f = 2 * (d * 2 * di + dims.d_conv * di + di * (dtr + 2 * n) + dtr * di + di * d)
    return f + 4 * di * n


def dense_token_flops(dims: Dims) -> int:
    return 6 * dims.d_model * dims.d_ff


def moe_token_flops(dims: Dims) -> int:
    """The router, the routed experts the token picks and the shared ones."""
    d = dims.d_model
    return 2 * d * dims.n_experts + 6 * d * dims.d_expert * (dims.top_k + dims.n_shared)


MIXER_FLOPS = {"mla": mla_token_flops, "attn": gqa_token_flops, "mamba": mamba_token_flops}
FFN_FLOPS = {"dense": dense_token_flops, "moe": moe_token_flops}


def block_token_flops(dims: Dims, i: int, ctx: int) -> int:
    """Model FLOPs of layer `i`'s mixer and FFN for one token that attends
    over `ctx` keys."""
    mixer, ffn = dims.sigs[i]
    return MIXER_FLOPS[mixer](dims, ctx) + FFN_FLOPS[ffn](dims)


def layer_token_flops(dims: Dims, i: int, ctx: int) -> int:
    """The family's `layer_token_flops`, or `block_token_flops`."""
    return getattr(family(dims.model_type), "layer_token_flops", block_token_flops)(dims, i, ctx)


def token_flops(dims: Dims, ctx: int) -> int:
    """Every layer's FLOPs for one token attending over `ctx` keys."""
    return sum(layer_token_flops(dims, i, ctx) for i in range(dims.n_layers))


def head_flops(dims: Dims) -> int:
    """The final projection of one row to the vocabulary's logits."""
    return 2 * dims.d_model * dims.vocab


def window_flops(dims: Dims, decode_ctx: Iterable[int],
                 prefill_rows: Iterable[Tuple[int, int]]) -> float:
    """Model FLOPs of the tokens computed in a window: decode tokens at
    their context lengths (each with its logits row), and prefill rows
    given as (cached tokens before the row, tokens computed), each
    computed token at its own context length, with one logits row each
    (a prefill call samples from its last token only). A token's FLOPs
    are linear in its context length: base + per_key * ctx."""
    base = token_flops(dims, 0)
    per_key = token_flops(dims, 1) - base
    head = head_flops(dims)
    n = keys = rows = 0
    for ctx in decode_ctx:
        n, keys, rows = n + 1, keys + ctx, rows + 1
    for past, m in prefill_rows:
        # contexts past + 1 .. past + m
        n, keys, rows = n + m, keys + m * past + m * (m + 1) // 2, rows + 1
    return float(n * base + keys * per_key + rows * head)
