"""Model assembly for training and serving (port of repro/models/model.py:
`layer_signature` :41, `stack_plan` :58, `init_params` :107,
`init_layer_cache` :147, `init_cache` :172, the attention, MoE (tiered
and flat, :362-377) and recurrent branches of `apply_layer` :195
(:301-336 for Mamba / mLSTM / sLSTM) and its cacheless full mode,
`_logits` :400, `forward_train` :407, `prefill` :462, `decode_step` :565,
`decode_step_paged` :640, `prefill_paged` :730, `decode_verify` :824).

Params keep the JAX tree layout: periodic layers are stacked under
params["stack"]["slot<j>"] with the scan-group dim first. Where JAX
runs `jax.lax.scan` over that dim, the port runs a Python loop over
groups on views of the stacked tensors. Caches are updated in place: an
attention layer's K/V pools or ring buffers, and a recurrent layer's
per-row state (the "state" subtree: {ssm, conv}, {C, n, m} or
{c, n, h, m}), which the paged layout keeps beside the pools, one row
per slot (`init_states`).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xl
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


class Mixer(NamedTuple):
    """What the port knows of one mixer kind: its params and its
    functions. An attention mixer caches token-addressed leaves
    (`cache_shapes`: keys in the order its functions take them, with
    their per-token shapes), ring buffers in the contiguous layout
    (whole-sequence `forward`, one-token `decode`) and block pools in the
    paged one (`decode_paged`, chunk `prefill_paged`). A recurrent mixer
    caches one state per row (`init_state`) in either layout: its
    `forward` (x, token_mask) starts from the init state and returns
    (y, state), its `decode` (x, state) returns (y, state)."""

    init: Callable
    forward: Callable
    decode: Callable
    decode_paged: Optional[Callable] = None
    prefill_paged: Optional[Callable] = None
    cache_shapes: Optional[Callable] = None  # (cfg, n_tokens) -> {cache key: shape}
    init_state: Optional[Callable] = None  # (cfg, batch, dtype, device) -> {key: tensor}


def _recurrent(init, forward, decode, init_state) -> Mixer:
    return Mixer(init, lambda p, cfg, x, token_mask: forward(
        p, cfg, x, return_state=True, token_mask=token_mask), decode, init_state=init_state)


MIXERS = {  # the mixers the port serves
    "attn": Mixer(attn.init_gqa, attn.gqa_forward, attn.gqa_decode, attn.gqa_decode_paged,
                  attn.gqa_prefill_paged, attn.gqa_cache_shapes),
    "mla": Mixer(attn.init_mla, attn.mla_forward, attn.mla_decode, attn.mla_decode_paged,
                 attn.mla_prefill_paged, attn.mla_cache_shapes),
    "mamba": _recurrent(mb.init_mamba, mb.mamba_forward, mb.mamba_decode,
                        mb.mamba_init_state),
    "mlstm": _recurrent(xl.init_mlstm, xl.mlstm_forward, xl.mlstm_decode,
                        lambda cfg, b, dt, dev: xl.mlstm_init_state(cfg, b, dev)),
    "slstm": _recurrent(xl.init_slstm, xl.slstm_forward, xl.slstm_decode,
                        lambda cfg, b, dt, dev: xl.slstm_init_state(cfg, b, dev)),
}


def check_supported(cfg: ModelConfig) -> None:
    """The port serves every decoder-only config; encoder-decoder models
    are a later slice."""
    if cfg.encdec is not None:
        raise NotImplementedError("encoder-decoder models are not ported yet")


def is_recurrent(cfg: ModelConfig) -> bool:
    """Whether any layer carries per-row recurrent state."""
    unrolled, _, period = stack_plan(cfg)
    sigs = [layer_signature(cfg, i) for i in unrolled] + list(period)
    return any(MIXERS[mixer].init_state is not None for mixer, _ in sigs)


# ------------------------------------------------------------ layer init
def init_layer(gen, cfg: ModelConfig, sig: Sig, lead=()) -> Params:
    mixer, ffn = sig
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    p: Params = {
        "norm1": init_rmsnorm(cfg.d_model, dt, dev, lead),
        "mixer": MIXERS[mixer].init(gen, cfg, lead),
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


# ------------------------------------------------------------ cache init
def layer_tree(cfg: ModelConfig, leaf_fn) -> Params:
    """{"layer<i>": leaf_fn(sig, ()), "stack": {"slot<j>": leaf_fn(sig,
    (n_groups,))}}: the cache tree layout, one subtree per layer."""
    unrolled_idx, n_groups, period = stack_plan(cfg)
    tree: Params = {f"layer{li}": leaf_fn(layer_signature(cfg, li), ())
                    for li in unrolled_idx}
    tree["stack"] = {f"slot{j}": leaf_fn(sig, (n_groups,)) for j, sig in enumerate(period)}
    return tree


def init_layer_state(cfg: ModelConfig, sig: Sig, batch: int, device=None,
                     lead=()) -> Params:
    """A recurrent layer's per-row state at its init values and dtypes
    ({"state": {key: [*lead, batch, ...]}}: the SSM state fp32 under bf16
    params, xLSTM's m at -inf); {} for an attention layer."""
    m = MIXERS[sig[0]]
    if m.init_state is None:
        return {}
    state = m.init_state(cfg, batch, torch_dtype(cfg.param_dtype), device)
    return {"state": {k: v.expand(*lead, *v.shape).clone() for k, v in state.items()}}


def init_layer_cache(cfg: ModelConfig, sig: Sig, batch: int, seq: int, device=None,
                     lead=()) -> Params:
    """One layer's contiguous cache: zeroed ring buffers [*lead, batch,
    seq, ...] per leaf of an attention mixer's `cache_shapes`, or a
    recurrent mixer's init state."""
    m = MIXERS[sig[0]]
    if m.cache_shapes is None:
        return init_layer_state(cfg, sig, batch, device, lead)
    dt = torch_dtype(cfg.param_dtype)
    return {k: torch.zeros((*lead, batch, *shape), dtype=dt, device=device)
            for k, shape in m.cache_shapes(cfg, seq).items()}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Params:
    """The contiguous decode cache: "layer<i>" leaves [batch, ...], "stack"
    leaves [n_groups, batch, ...]."""
    check_supported(cfg)
    return layer_tree(cfg, lambda sig, lead: init_layer_cache(cfg, sig, batch, seq, device,
                                                              lead))


def init_states(cfg: ModelConfig, batch: int, device=None) -> Params:
    """The per-row recurrent state of every layer ({} for attention
    layers), in the cache tree layout: the paged layout's `slot_state`."""
    return layer_tree(cfg, lambda sig, lead: init_layer_state(cfg, sig, batch, device, lead))


def unbind_tree(tree, n: int) -> list:
    """The `n` scan groups of a stacked subtree, one `torch.unbind` per
    leaf: its backward stacks the groups' gradients in one pass, where
    indexing group by group would add a full-size zero gradient per group."""
    if isinstance(tree, dict):
        parts = {k: unbind_tree(v, n) for k, v in tree.items()}
        return [{k: part[g] for k, part in parts.items()} for g in range(n)]
    return list(torch.unbind(tree, 0))


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
    cache: Params | None,  # this layer's cache, written in place: an
                    # attention layer's leaves keyed as
                    # MIXERS[mixer].cache_shapes (block pools when
                    # `tables` is given, else ring buffers [B, S, ...]);
                    # a recurrent layer's rows' {"state": {...}} ([B, ...])
                    # in either layout. None: the cacheless full mode of
                    # training, which writes nothing
    tables: torch.Tensor | None = None,  # [B, nb] int32 block tables
    pos: torch.Tensor | None = None,  # decode: [B] int32 positions
    past_len: torch.Tensor | None = None,  # chunk prefill: [B] int32
    token_mask: torch.Tensor | None = None,  # [B, S] valid tokens
    tiered_state: Params | None = None,
    cold_capacity_frac: float = 0.25,
):
    """One layer. Decode when `pos` is given (x [B, 1, D]), full-sequence
    otherwise (x [B, S, D], `token_mask`): over the paged pools (a chunk
    after `past_len` cached tokens) when `tables` is given, else over the
    contiguous layout, where the tokens' entries land at the head of the
    rows' ring buffers with pad entries zeroed (the reference's
    `prefill.merge`), or, with `cache=None`, over no cache at all. A
    recurrent layer decodes from its rows' state and otherwise runs the
    masked forward from the init state (a paged chunk included, as the
    reference's), and writes the new state over the old. Returns (x,
    aux loss (fp32 scalar; None without a flat MoE), expert_counts [E]
    int32 or None)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    m = MIXERS[sig[0]]
    if m.init_state is not None:
        y, new = (m.decode(p["mixer"], cfg, h, cache["state"]) if pos is not None
                  else m.forward(p["mixer"], cfg, h, token_mask))
        if cache is not None:
            for key, val in new.items():
                cache["state"][key].copy_(val)
    elif cache is None:
        y, _ = m.forward(p["mixer"], cfg, h, positions, token_mask)
    else:
        keys = list(m.cache_shapes(cfg, 0))
        a, b = (cache[key] for key in keys)
        if pos is not None and tables is not None:
            y, _, _ = m.decode_paged(p["mixer"], cfg, h, a, b, tables, pos)
        elif pos is not None:
            y, _, _ = m.decode(p["mixer"], cfg, h, a, b, pos)
        elif tables is not None:
            y, _, _ = m.prefill_paged(p["mixer"], cfg, h, a, b, tables, past_len, positions,
                                      token_mask)
        else:
            y, new = m.forward(p["mixer"], cfg, h, positions, token_mask)
            s = x.shape[1]
            for key, val in zip(keys, new):
                if token_mask is not None:  # pad entries zeroed
                    val = val * token_mask[(...,) + (None,) * (val.ndim - 2)].to(val.dtype)
                cache[key][:, :s] = val
    return _ffn(cfg, sig, p, x + y, token_mask, tiered_state, cold_capacity_frac,
                decode=pos is not None)


def _ffn(cfg, sig, p, x, token_mask, tiered_state, cold_capacity_frac, decode):
    """A layer's FFN half: (x, aux loss or None, expert_counts [E] int32 or None).
    Routed experts run through the TriMoE tiers when `tiered_state` is
    given, else through the flat `moe_forward` (reference :362-377):
    dropless in decode and under a token mask (capacity from the padded
    token count would make padded and unpadded prefill diverge)."""
    ffn = sig[1]
    aux = counts = None
    if ffn != "none":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if ffn == "moe" and tiered_state is not None:
            from repro_torch.serving.tiered_moe import tiered_moe_forward

            y_moe, counts = tiered_moe_forward(
                p["ffn"], tiered_state, cfg, h2,
                cold_capacity_frac=cold_capacity_frac, token_mask=token_mask,
            )
            x = x + y_moe
        elif ffn == "moe":
            out = moe_lib.moe_forward(p["ffn"], cfg, h2,
                                      full_capacity=decode or token_mask is not None,
                                      token_mask=token_mask)
            x, aux, counts = x + out.y, out.aux_loss, out.expert_counts
        else:
            x = x + mlp(p["ffn"], h2)
    return x, aux, counts


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return lm_head(params["head"], x)


def forward_train(params: Params, cfg: ModelConfig, batch, remat: bool = True):
    """The training forward (reference :407): batch {"tokens": [B, S]
    int}, no cache, every MoE layer through the flat `moe_forward` at
    the config's capacity factor. Returns (logits [B, S, V], aux loss
    (fp32 scalar, summed over layers), expert counts [n_groups * period,
    E] int32: the scanned groups' layers only, zeros for a layer without
    routed experts, as the reference returns them). With `remat`, each
    layer group is activation-checkpointed (`torch.utils.checkpoint`,
    non-reentrant): only its input is kept, and its forward, the MoE
    kernels included, runs again in the backward pass (the reference
    saves its matmul outputs without batch dims as well)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    unrolled_idx, n_groups, period = stack_plan(cfg)
    x = embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)[None, :]
    e = cfg.moe.n_experts if cfg.moe is not None else 1
    no_moe = torch.zeros((e,), dtype=torch.int32, device=x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in unrolled_idx:
        x, aux, _ = apply_layer(cfg, layer_signature(cfg, li), params[f"layer{li}"], x,
                                positions, cache=None)
        aux_total = aux_total if aux is None else aux_total + aux

    def group(x, aux_sum, p):
        counts = []
        for j, sig in enumerate(period):
            x, aux, c = apply_layer(cfg, sig, p[f"slot{j}"], x, positions, cache=None)
            aux_sum = aux_sum if aux is None else aux_sum + aux
            counts.append(no_moe if c is None else c)
        return x, aux_sum, torch.stack(counts)

    counts_all = []
    for p in unbind_tree(params["stack"], n_groups):
        if remat:
            x, aux_total, counts = checkpoint(group, x, aux_total, p, use_reentrant=False)
        else:
            x, aux_total, counts = group(x, aux_total, p)
        counts_all.append(counts)
    return _logits(params, cfg, x), aux_total, torch.cat(counts_all)


def _layers(params: Params, cfg: ModelConfig, cache: Params, tiered: Params | None,
            states: Params | None = None):
    """(sig, layer params, layer cache, tier state) for every layer in
    execution order; stacked leaves come as views of their group. `cache`
    is the paged pools or the contiguous cache (same tree layout); the
    paged layout's per-row `states` merge into each layer's cache."""
    unrolled_idx, n_groups, period = stack_plan(cfg)

    def merged(c, s):
        return c if s is None else {**c, **s}

    for li in unrolled_idx:
        name = f"layer{li}"
        ts = tiered.get(name) if tiered else None
        st = None if states is None else states[name]
        yield layer_signature(cfg, li), params[name], merged(cache[name], st), ts
    ts_stack = tiered.get("stack") if tiered else None
    for g in range(n_groups):
        for j, sig in enumerate(period):
            slot = f"slot{j}"
            ts = index_tree(ts_stack[slot], g) if ts_stack and slot in ts_stack else None
            st = None if states is None else index_tree(states["stack"][slot], g)
            yield (sig, index_tree(params["stack"][slot], g),
                   merged(index_tree(cache["stack"][slot], g), st), ts)


def _last_real(x: torch.Tensor, token_mask: torch.Tensor | None) -> torch.Tensor:
    """Each row's hidden state at its last real token ([B, 1, D]); an
    all-pad row yields position 0."""
    if token_mask is None:
        return x[:, -1:]
    last = torch.clamp(token_mask.sum(-1) - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), last][:, None]


def _walk(params, cfg, x, positions, cache, tiered, cold_capacity_frac, states=None,
          **layer_kw):
    """Every layer in execution order over `cache` (the paged pools or
    the contiguous cache) and, in the paged layout, the rows' recurrent
    `states`; `layer_kw` selects the mode as `apply_layer` reads it.
    Returns (x, expert counts [n_layers, E], new states): one counts row
    per layer, zeros for a layer without routed experts, as the
    reference returns them; the states are `states` (or, contiguous,
    `cache`), written in place."""
    e = cfg.moe.n_experts if cfg.moe is not None else 1
    no_moe = torch.zeros((e,), dtype=torch.int32, device=x.device)
    counts_all = []
    for sig, p, c, ts in _layers(params, cfg, cache, tiered, states):
        x, _, counts = apply_layer(cfg, sig, p, x, positions, cache=c, tiered_state=ts,
                                   cold_capacity_frac=cold_capacity_frac, **layer_kw)
        counts_all.append(no_moe if counts is None else counts)
    return x, torch.stack(counts_all), cache if states is None else states


def _decode(params, cfg, tokens, cache, tables, pos, tiered, cold_capacity_frac,
            token_mask, states=None):
    """One decode step over either layout: (logits [B, V], counts [L, E],
    states)."""
    tmask = None if token_mask is None else token_mask.reshape(-1, 1)
    x, counts, states = _walk(params, cfg, embed(params["embed"], tokens), pos[:, None],
                              cache, tiered, cold_capacity_frac, states, tables=tables,
                              pos=pos, token_mask=tmask)
    return _logits(params, cfg, x)[:, 0], counts, states


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    cache_len: int | None = None,
    tiered: Params | None = None,
    cold_capacity_frac: float = 0.25,
    token_mask: torch.Tensor | None = None,  # [B, S] bool real tokens
):
    """Full-sequence prefill building a fresh contiguous cache of
    `cache_len` (default S) slots per row. Without `token_mask` every row
    is S real tokens (the exact-length path). With it, rows are right-
    padded to a shared bucket width: pad keys are masked out of attention,
    pad cache entries are zeroed, and the logits are each row's last real
    token's (an all-pad row yields row position 0: callers drop such
    rows). MoE layers run through the tiered runtime when `tiered` is
    given. Returns (logits [B, V], cache)."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, cache_len or s, device=tokens.device)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    x, _, cache = _walk(params, cfg, embed(params["embed"], tokens), positions, cache,
                        tiered, cold_capacity_frac, token_mask=token_mask)
    return _logits(params, cfg, _last_real(x, token_mask))[:, 0], cache


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, 1] int
    cache: Params,
    pos: torch.Tensor,  # [B] int32 (or a scalar: every row at one position)
    tiered: Params | None = None,
    cold_capacity_frac: float = 0.25,
    token_mask: torch.Tensor | None = None,  # [B] live rows
):
    """One decode step against the contiguous cache (ring buffers written
    in place at pos % S, recurrent states over the old). Returns (logits
    [B, V], cache, expert_counts [n_layers, E]): one row per layer, zeros
    for a layer without routed experts, as the reference's `decode_step`
    returns them."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device).expand(tokens.shape[0])
    logits, counts, cache = _decode(params, cfg, tokens, cache, None, pos, tiered,
                                    cold_capacity_frac, token_mask)
    return logits, cache, counts


def decode_step_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, 1] int
    pools: Params,
    states: Params,  # the rows' recurrent state (`init_states` layout, [B, ...])
    tables: torch.Tensor,  # [B, nb] int32
    pos: torch.Tensor,  # [B] int32
    tiered: Params | None = None,
    cold_capacity_frac: float = 0.25,
    token_mask: torch.Tensor | None = None,  # [B] live rows
):
    """One decode step against the paged KV cache. Returns (logits
    [B, V], pools, states (both written in place), expert_counts
    [n_layers, E]): one counts row per layer in execution order, zeros for
    a layer without routed experts, as the reference's
    `decode_step_paged` returns them. Dead rows' states advance too, as
    the reference's do (admission prefill overwrites them)."""
    logits, counts, states = _decode(params, cfg, tokens, pools, tables, pos, tiered,
                                     cold_capacity_frac, token_mask, states)
    return logits, pools, states, counts


def _chunk(params, cfg, tokens, pools, tables, past_len, token_mask, tiered,
           cold_capacity_frac):
    """One masked chunk at positions past_len + [0, S) against the paged
    pools, recurrent layers from their init state: (hidden states
    [W, S, D], expert counts [n_layers, E], the rows' new states)."""
    s = tokens.shape[1]
    positions = (past_len[:, None]
                 + torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :])
    states = init_states(cfg, tokens.shape[0], tokens.device)
    return _walk(params, cfg, embed(params["embed"], tokens), positions, pools, tiered,
                 cold_capacity_frac, states, tables=tables, past_len=past_len,
                 token_mask=token_mask)


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
    (decode is the chunk-of-1 case of the same kernels). Recurrent layers
    run the masked forward from the init state: rows with past_len > 0
    need an attention-only arch, which the loop's `chunked` gate ensures.
    Returns (last_real_token_logits [W, V], pools written in place, the
    rows' recurrent states [W, ...])."""
    x, _, states = _chunk(params, cfg, tokens, pools, tables, past_len, token_mask, tiered,
                          cold_capacity_frac)
    return _logits(params, cfg, _last_real(x, token_mask))[:, 0], pools, states


def decode_verify(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [W, K] int
    pools: Params,
    tables: torch.Tensor,  # [W, nb] int32, sliced to the active width
    past_len: torch.Tensor,  # [W] int32 committed tokens before the chunk
    token_mask: torch.Tensor,  # [W, K] bool real chunk tokens
    tiered: Params | None = None,
    cold_capacity_frac: float = 0.25,
):
    """Speculative chunk-of-k verification against the paged cache: the
    forward of `prefill_paged` over each row's [sampled token, draft_1..]
    chunk, keeping what prefill drops: the logits at EVERY chunk position
    (the accept rule compares draft i with the argmax after position
    i - 1) and the expert counts (a verify step feeds the tier scheduler
    as the decode step it replaces does). A chunk of 1 is the decode
    step: the same kernel launches, and on the CPU the same plain
    functions on the same shapes. Returns (logits [W, K, V], pools
    written in place, expert_counts [n_layers, E]).

    A recurrent arch raises: a chunk would restart its layers from the
    init state, not the rows' (the reference passes `cache={}` there,
    model.py:857-867, behind the loop's spec gate)."""
    if is_recurrent(cfg):
        raise ValueError(
            "decode_verify requires an attention-only arch: a verify chunk "
            "cannot thread the rows' recurrent state"
        )
    x, counts, _ = _chunk(params, cfg, tokens, pools, tables, past_len, token_mask, tiered,
                       cold_capacity_frac)
    return _logits(params, cfg, x), pools, counts
