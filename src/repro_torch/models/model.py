"""Model assembly for serving (port of the serving part of
repro/models/model.py: `layer_signature` :41, `stack_plan` :58,
`init_params` :107, the attention and MoE branches of `apply_layer`
:195, `_logits` :400, `decode_step_paged` :640, `prefill_paged` :730).

Params keep the JAX tree layout: periodic layers are stacked under
params["stack"]["slot<j>"] with the scan-group dim first. Where JAX
runs `jax.lax.scan` over that dim, the port runs a Python loop over
groups on views of the stacked tensors. K/V pools are updated in place.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    Params,
    embed,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_rmsnorm,
    lm_head,
    mlp,
    rmsnorm,
    torch_dtype,
    unembed,
)

Sig = Tuple[str, str]  # (mixer, ffn)


# ----------------------------------------------------------- layer plans
def layer_signature(cfg: ModelConfig, i: int) -> Sig:
    if cfg.xlstm is not None:
        kind = cfg.xlstm.pattern[i % len(cfg.xlstm.pattern)]
        return ("mlstm" if kind == "m" else "slstm", "none")
    if cfg.uses_attention_layer(i):
        mixer = "mla" if cfg.mla is not None else "attn"
    else:
        mixer = "mamba"
    if cfg.uses_moe_layer(i):
        ffn = "moe"
    elif cfg.d_ff > 0:
        ffn = "dense"
    else:
        ffn = "none"
    return (mixer, ffn)


def stack_plan(cfg: ModelConfig) -> Tuple[List[int], int, List[Sig]]:
    """Return (unrolled_prefix_indices, n_scan_groups, period_sigs)."""
    sigs = [layer_signature(cfg, i) for i in range(cfg.n_layers)]
    for offset in range(0, 3):
        rest = sigs[offset:]
        for period in range(1, 17):
            if len(rest) % period:
                continue
            pat = rest[:period]
            if all(rest[i] == pat[i % period] for i in range(len(rest))):
                return list(range(offset)), len(rest) // period, pat
    raise ValueError(f"no periodic plan for {cfg.name}: {sigs}")


def check_supported(cfg: ModelConfig) -> None:
    """This slice serves GQA attention with MoE or dense FFNs; MLA,
    recurrent mixers and encoder-decoder models are later slices."""
    if cfg.encdec is not None:
        raise NotImplementedError("encoder-decoder models are not ported yet")
    unrolled, _, period = stack_plan(cfg)
    for mixer, _ffn in [layer_signature(cfg, i) for i in unrolled] + list(period):
        if mixer != "attn":
            raise NotImplementedError(f"{mixer} layers are not ported yet")


# ------------------------------------------------------------ layer init
def init_layer(gen, cfg: ModelConfig, sig: Sig, lead=()) -> Params:
    mixer, ffn = sig
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    p: Params = {
        "norm1": init_rmsnorm(cfg.d_model, dt, dev, lead),
        "mixer": attn.init_gqa(gen, cfg, lead),
    }
    if ffn != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, dt, dev, lead)
        if ffn == "moe":
            p["ffn"] = moe_lib.init_moe(gen, cfg, lead)
        else:
            p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt, lead)
    return p


def resolve_device(device) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run its plain PyTorch versions on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def init_params(seed: int, cfg: ModelConfig, device=None) -> Params:
    """Seeded random params in the JAX tree layout, drawn on `device`
    (default: the GPU) from a `torch.Generator`."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    unrolled_idx, n_groups, period = stack_plan(cfg)
    dt = torch_dtype(cfg.param_dtype)
    params: Params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt)}
    for li in unrolled_idx:
        params[f"layer{li}"] = init_layer(gen, cfg, layer_signature(cfg, li))
    params["stack"] = {
        f"slot{j}": init_layer(gen, cfg, sig, lead=(n_groups,))
        for j, sig in enumerate(period)
    }
    params["final_norm"] = init_rmsnorm(cfg.d_model, dt, device)
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(gen, cfg.d_model, cfg.vocab_size, dt)
    return params


def index_tree(tree, g: int):
    """Views of scan group `g` of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: index_tree(v, g) for k, v in tree.items()}
    return tree[g]


# ---------------------------------------------------------- layer apply
def apply_layer(
    cfg: ModelConfig,
    sig: Sig,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    pools: Params,  # {"k", "v"} block pools of this layer (written in place)
    tables: torch.Tensor,  # [B, nb] int32 block tables
    pos: torch.Tensor | None = None,  # decode: [B] int32 positions
    past_len: torch.Tensor | None = None,  # chunk prefill: [B] int32
    token_mask: torch.Tensor | None = None,  # [B, S] valid tokens
    tiered_state: Params | None = None,
    cold_capacity_frac: float = 0.25,
):
    """One paged serving layer. Decode when `pos` is given (x [B, 1, D]),
    chunk prefill otherwise (x [B, S, D], `past_len`, `token_mask`).
    Returns (x, expert_counts [E] int32 or None)."""
    mixer, ffn = sig
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if pos is not None:
        y, _, _ = attn.gqa_decode_paged(p["mixer"], cfg, h, pools["k"], pools["v"],
                                        tables, pos)
    else:
        y, _, _ = attn.gqa_prefill_paged(p["mixer"], cfg, h, pools["k"], pools["v"],
                                         tables, past_len, positions, token_mask)
    x = x + y
    counts = None
    if ffn != "none":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if ffn == "moe":
            if tiered_state is None:
                raise NotImplementedError("the flat moe_forward is a later slice")
            from repro_torch.serving.tiered_moe import tiered_moe_forward

            y_moe, counts = tiered_moe_forward(
                p["ffn"], tiered_state, cfg, h2,
                cold_capacity_frac=cold_capacity_frac, token_mask=token_mask,
            )
            x = x + y_moe
        else:
            x = x + mlp(p["ffn"], h2)
    return x, counts


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return lm_head(params["head"], x)


def _layers(params: Params, cfg: ModelConfig, pools: Params, tiered: Params | None):
    """(sig, layer params, layer pools, tier state) for every layer in
    execution order; stacked leaves come as views of their group."""
    unrolled_idx, n_groups, period = stack_plan(cfg)
    for li in unrolled_idx:
        name = f"layer{li}"
        ts = tiered.get(name) if tiered else None
        yield layer_signature(cfg, li), params[name], pools[name], ts
    ts_stack = tiered.get("stack") if tiered else None
    for g in range(n_groups):
        for j, sig in enumerate(period):
            slot = f"slot{j}"
            ts = index_tree(ts_stack[slot], g) if ts_stack and slot in ts_stack else None
            yield (sig, index_tree(params["stack"][slot], g),
                   index_tree(pools["stack"][slot], g), ts)


def decode_step_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, 1] int
    pools: Params,
    tables: torch.Tensor,  # [B, nb] int32
    pos: torch.Tensor,  # [B] int32
    tiered: Params | None = None,
    cold_capacity_frac: float = 0.25,
    token_mask: torch.Tensor | None = None,  # [B] live rows
):
    """One decode step against the paged KV cache. Returns (logits
    [B, V], pools (written in place), expert_counts [n_moe_layers, E])."""
    x = embed(params["embed"], tokens)
    positions = pos[:, None]
    tmask = None if token_mask is None else token_mask.reshape(-1, 1)
    counts_all = []
    for sig, p, pl, ts in _layers(params, cfg, pools, tiered):
        x, counts = apply_layer(
            cfg, sig, p, x, positions, pools=pl, tables=tables, pos=pos,
            token_mask=tmask, tiered_state=ts, cold_capacity_frac=cold_capacity_frac,
        )
        if counts is not None:
            counts_all.append(counts)
    logits = _logits(params, cfg, x)[:, 0]
    e = cfg.moe.n_experts if cfg.moe is not None else 1
    counts = (torch.stack(counts_all) if counts_all
              else torch.zeros((0, e), dtype=torch.int32, device=x.device))
    return logits, pools, counts


def prefill_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [W, S] int
    pools: Params,
    tables: torch.Tensor,  # [W, nb] int32, sliced to the active width
    past_len: torch.Tensor,  # [W] int32 tokens cached before the chunk
    token_mask: torch.Tensor,  # [W, S] bool real tokens
    tiered: Params | None = None,
    cold_capacity_frac: float = 0.25,
):
    """Suffix-only masked prefill of one chunk against the paged cache
    (decode is the chunk-of-1 case of the same kernels). Returns
    (last_real_token_logits [W, V], pools written in place)."""
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    positions = past_len[:, None] + torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    for sig, p, pl, ts in _layers(params, cfg, pools, tiered):
        x, _ = apply_layer(
            cfg, sig, p, x, positions, pools=pl, tables=tables, past_len=past_len,
            token_mask=token_mask, tiered_state=ts, cold_capacity_frac=cold_capacity_frac,
        )
    last = torch.clamp(token_mask.sum(-1) - 1, min=0)
    x_last = x[torch.arange(b, device=x.device), last][:, None]
    return _logits(params, cfg, x_last)[:, 0], pools

