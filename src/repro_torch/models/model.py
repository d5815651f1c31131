"""Model assembly for training and serving (port of repro/models/model.py:
`layer_signature` :41, `stack_plan` :58, `init_layer` :87 (cross
attention :101-103), `init_params` :107 (the encoder :131-142),
`init_layer_cache` :147 (cross K/V :165-168), `init_cache` :172, the
attention, cross-attention (:341-348), MoE (tiered and flat, :362-377) and
recurrent branches of `apply_layer` :195 (:301-336 for Mamba / mLSTM /
sLSTM) and its cacheless full mode, `_run_encoder` :380, `_cross_kv` :394,
`_logits` :400, `forward_train` :407, `prefill` :462, `decode_step` :565,
`decode_step_paged` :640, `prefill_paged` :730, `decode_verify` :824).

Encoder-decoder models (seamless-m4t) run the contiguous functions only,
as in the reference, whose paged prefill and verify assert `encdec is
None`: `forward_train` and `prefill` take the encoder's input frames
[B, F, D], every decoder layer attends over its own projection of the
encoder output (`ck` / `cv` [B, F, Kv, hd], no RoPE, no key mask), which
`prefill` stores in the cache and `decode_step` reads from it.

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
    make_generator,
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


def check_decoder_only(cfg: ModelConfig, what: str) -> None:
    """The paged layout, `decode_verify` and the serving loop refuse
    encoder-decoder models, as the reference's asserts do (model.py:767,
    :852; serving/paged_kv.py:293): a paged row holds no cross K/V and the
    loop carries no frames. The contiguous functions run them."""
    if cfg.encdec is not None:
        raise NotImplementedError(f"{what} does not support encoder-decoder models")


def has_cross(cfg: ModelConfig) -> bool:
    """Whether every decoder layer attends over the encoder's output."""
    return cfg.encdec is not None and cfg.encdec.cross_attention


def check_frames(params: Params, cfg: ModelConfig, frames) -> None:
    """Frames must come in the params' dtype. The reference runs its
    encoder and decoder layers under `lax.scan`, whose carry keeps its
    input dtype: bf16 frames under fp32 params (the encoder's residual
    promotes) or fp32 frames under bf16 params (the decoder's residual
    promotes at the first cross attention) raise a TypeError there, so
    they do here rather than run a mix the reference never computes."""
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: pass its frames")
    dt = params["embed"]["table"].dtype
    if frames.dtype != dt:
        raise TypeError(f"frames are {frames.dtype}, the params {dt}: an encoder-decoder "
                        f"model takes frames in the params' dtype")


def is_recurrent(cfg: ModelConfig) -> bool:
    """Whether any layer carries per-row recurrent state."""
    unrolled, _, period = stack_plan(cfg)
    sigs = [layer_signature(cfg, i) for i in unrolled] + list(period)
    return any(MIXERS[mixer].init_state is not None for mixer, _ in sigs)


# ------------------------------------------------------------ layer init
def init_layer(gen, cfg: ModelConfig, sig: Sig, lead=(), cross: bool = False) -> Params:
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
    if cross:
        p["norm_cross"] = init_rmsnorm(cfg.d_model, dt, dev, lead)
        p["cross"] = attn.init_gqa(gen, cfg, lead)
    return p


def resolve_device(device) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU. A
    card without an index is the current one (`cuda:0` by default), as
    the tensors made on it name it: the loop compares the two."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run its plain PyTorch versions on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def init_params(seed: int, cfg: ModelConfig, device=None) -> Params:
    """Seeded random params in the JAX tree layout, drawn on `device`
    (default: the GPU) from a `torch.Generator`; on the meta device
    (shapes and dtypes only) from a CPU one."""
    device = resolve_device(device)
    gen = make_generator(seed, device)
    unrolled_idx, n_groups, period = stack_plan(cfg)
    dt = torch_dtype(cfg.param_dtype)
    cross = has_cross(cfg)
    params: Params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt)}
    for li in unrolled_idx:
        params[f"layer{li}"] = init_layer(gen, cfg, layer_signature(cfg, li), cross=cross)
    params["stack"] = {
        f"slot{j}": init_layer(gen, cfg, sig, lead=(n_groups,), cross=cross)
        for j, sig in enumerate(period)
    }
    params["final_norm"] = init_rmsnorm(cfg.d_model, dt, device)
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(gen, cfg.d_model, cfg.vocab_size, dt)
    if cfg.encdec is not None:
        params["encoder"] = {
            # every encoder layer is ("attn", "dense") (reference :132)
            "stack": {"slot0": init_layer(gen, cfg, ("attn", "dense"),
                                          lead=(cfg.encdec.n_encoder_layers,))},
            "final_norm": init_rmsnorm(cfg.d_model, dt, device),
        }
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
    recurrent mixer's init state; an encoder-decoder layer's cross K/V
    (`ck` / `cv` [*lead, batch, frames, Kv, hd]) besides."""
    m = MIXERS[sig[0]]
    dt = torch_dtype(cfg.param_dtype)
    if m.cache_shapes is None:
        c = init_layer_state(cfg, sig, batch, device, lead)
    else:
        c = {k: torch.zeros((*lead, batch, *shape), dtype=dt, device=device)
             for k, shape in m.cache_shapes(cfg, seq).items()}
    if has_cross(cfg):
        kv = (*lead, batch, cfg.encdec.frontend_frames, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        c["ck"] = torch.zeros(kv, dtype=dt, device=device)
        c["cv"] = torch.zeros(kv, dtype=dt, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Params:
    """The contiguous decode cache: "layer<i>" leaves [batch, ...], "stack"
    leaves [n_groups, batch, ...]."""
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
    cross_kv: Tuple[torch.Tensor, torch.Tensor] | None = None,  # training's (ck, cv)
):
    """One layer. Decode when `pos` is given (x [B, 1, D]), full-sequence
    otherwise (x [B, S, D], `token_mask`): over the paged pools (a chunk
    after `past_len` cached tokens) when `tables` is given, else over the
    contiguous layout, where the tokens' entries land at the head of the
    rows' ring buffers with pad entries zeroed (the reference's
    `prefill.merge`), or, with `cache=None`, over no cache at all. A
    recurrent layer decodes from its rows' state and otherwise runs the
    masked forward from the init state (a paged chunk included, as the
    reference's), and writes the new state over the old. A layer with
    cross attention then attends, non-causally and with no key mask, over
    the encoder's K/V: the cache's `ck` / `cv`, or `cross_kv` in the
    cacheless mode. Returns (x, aux loss (fp32 scalar; None without a
    flat MoE), expert_counts [E] int32 or None)."""
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
    x = x + y
    if "cross" in p:
        kv = cross_kv if cache is None else (cache["ck"], cache["cv"])
        hc = rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        yc, _ = attn.gqa_forward(p["cross"], cfg, hc, positions, kv_override=kv,
                                 causal=False)
        x = x + yc
    return _ffn(cfg, sig, p, x, token_mask, tiered_state, cold_capacity_frac,
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


def _encoder_layer(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    """One encoder layer: non-causal self-attention (RoPE at the frames'
    positions), then the dense FFN (the reference's `apply_layer` with
    causal=False and no cache)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, _ = attn.gqa_forward(p["mixer"], cfg, h, positions, causal=False)
    x = x + y
    return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))


def _run_encoder(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                 remat: bool = False) -> torch.Tensor:
    """The encoder stack over frames [B, F, D], then its final norm
    (reference :380). With `remat` each layer is activation-checkpointed,
    as `forward_train` checkpoints the decoder's groups: the same values,
    a layer's input kept instead of its score tensors."""
    check_frames(params, cfg, frames)
    enc = params["encoder"]
    positions = torch.arange(frames.shape[1], dtype=torch.int32, device=frames.device)[None, :]
    x = frames

    def layer(p, x):
        return _encoder_layer(cfg, p, x, positions)

    for p in unbind_tree(enc["stack"]["slot0"], cfg.encdec.n_encoder_layers):
        x = checkpoint(layer, p, x, use_reentrant=False) if remat else layer(p, x)
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _cross_kv(layer_p: Params, enc_out: torch.Tensor):
    """A decoder layer's cross K/V [B, F, Kv, hd] from the encoder output:
    no bias, no RoPE (reference :394)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, layer_p["cross"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, layer_p["cross"]["wv"])
    return k, v


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return lm_head(params["head"], x)


def forward_train(params: Params, cfg: ModelConfig, batch, remat: bool = True):
    """The training forward (reference :407): batch {"tokens": [B, S]
    int, and an encoder-decoder model's "frames" [B, F, D] in the params'
    dtype}, no cache, every MoE layer through the flat `moe_forward` at
    the config's capacity factor. Returns (logits [B, S, V], aux loss
    (fp32 scalar, summed over layers), expert counts [n_groups * period,
    E] int32: the scanned groups' layers only, zeros for a layer without
    routed experts, as the reference returns them). With `remat`, each
    layer group is activation-checkpointed (`torch.utils.checkpoint`,
    non-reentrant): only its input is kept, and its forward, the MoE
    kernels included, runs again in the backward pass (the reference
    saves its matmul outputs without batch dims as well); a layer group's
    cross K/V are taken inside it, so the recompute rebuilds them. On a
    device mesh see `mesh_forward_train`."""
    tokens = batch["tokens"]
    unrolled_idx, n_groups, period = stack_plan(cfg)
    x = embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)[None, :]
    e = cfg.moe.n_experts if cfg.moe is not None else 1
    no_moe = torch.zeros((e,), dtype=torch.int32, device=x.device)

    enc_out = None
    if cfg.encdec is not None:
        enc_out = _run_encoder(params, cfg, batch.get("frames"), remat)

    def layer(sig, lp, x, enc_out):
        cross_kv = None if enc_out is None else _cross_kv(lp, enc_out)
        return apply_layer(cfg, sig, lp, x, positions, cache=None, cross_kv=cross_kv)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in unrolled_idx:
        x, aux, _ = layer(layer_signature(cfg, li), params[f"layer{li}"], x, enc_out)
        aux_total = aux_total if aux is None else aux_total + aux

    def group(x, aux_sum, p, enc_out):
        counts = []
        for j, sig in enumerate(period):
            x, aux, c = layer(sig, p[f"slot{j}"], x, enc_out)
            aux_sum = aux_sum if aux is None else aux_sum + aux
            counts.append(no_moe if c is None else c)
        return x, aux_sum, torch.stack(counts)

    counts_all = []
    for p in unbind_tree(params["stack"], n_groups):
        if remat:
            x, aux_total, counts = checkpoint(group, x, aux_total, p, enc_out,
                                              use_reentrant=False)
        else:
            x, aux_total, counts = group(x, aux_total, p, enc_out)
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
    frames: torch.Tensor | None = None,  # [B, F, D]: an encoder-decoder model's input
    mesh=None,  # a DeviceMesh: params / tiered as DTensors, tokens (frames) this rank's rows
    batch: int | None = None,  # on a mesh: the global batch's rows (see _mesh_prefill)
):
    """Full-sequence prefill building a fresh contiguous cache of
    `cache_len` (default S) slots per row. Without `token_mask` every row
    is S real tokens (the exact-length path). With it, rows are right-
    padded to a shared bucket width: pad keys are masked out of attention,
    pad cache entries are zeroed, and the logits are each row's last real
    token's (an all-pad row yields row position 0: callers drop such
    rows). MoE layers run through the tiered runtime when `tiered` is
    given. An encoder-decoder model runs its encoder over `frames` first
    and stores each decoder layer's cross K/V in the cache (the reference
    puts `_cross_kv`'s arrays in place of the zeros, :525, :543).
    Returns (logits [B, V], cache). On a `mesh` see `_mesh_prefill`."""
    if mesh is not None:
        return _mesh_prefill(params, cfg, tokens, cache_len, tiered, cold_capacity_frac,
                             token_mask, mesh, frames, batch)
    b, s = tokens.shape
    cache = init_cache(cfg, b, cache_len or s, device=tokens.device)
    if cfg.encdec is not None:
        enc_out = _run_encoder(params, cfg, frames)
        for _, lp, c, _ in _layers(params, cfg, cache, None):
            for key, val in zip(("ck", "cv"), _cross_kv(lp, enc_out)):
                c[key].copy_(val)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    x, _, cache = _walk(params, cfg, embed(params["embed"], tokens), positions, cache,
                        tiered, cold_capacity_frac, token_mask=token_mask)
    return _logits(params, cfg, _last_real(x, token_mask))[:, 0], cache


def _row_positions(pos, tokens: torch.Tensor) -> torch.Tensor:
    """[B] int32 positions on the tokens' device from [B] or a scalar (an
    int made with a factory: a fake-tensor trace cannot copy host data)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=tokens.device, dtype=torch.int32)
        return pos.expand(tokens.shape[0])
    return torch.full((tokens.shape[0],), int(pos), dtype=torch.int32, device=tokens.device)


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, 1] int
    cache: Params,
    pos: torch.Tensor,  # [B] int32 (or a scalar: every row at one position)
    tiered: Params | None = None,
    cold_capacity_frac: float = 0.25,
    token_mask: torch.Tensor | None = None,  # [B] live rows
    mesh=None,  # a DeviceMesh: params / cache / tiered as DTensors, rows this rank's
):
    """One decode step against the contiguous cache (ring buffers written
    in place at pos % S, recurrent states over the old). Returns (logits
    [B, V], cache, expert_counts [n_layers, E]): one row per layer, zeros
    for a layer without routed experts, as the reference's `decode_step`
    returns them. On a `mesh` see `_mesh_decode`."""
    if mesh is not None:
        return _mesh_decode(params, cfg, tokens, cache, pos, tiered, cold_capacity_frac,
                            token_mask, mesh)
    pos = _row_positions(pos, tokens)
    logits, counts, cache = _decode(params, cfg, tokens, cache, None, pos, tiered,
                                    cold_capacity_frac, token_mask)
    return logits, cache, counts


# ------------------------------------------------------ on a device mesh
# each recurrent mixer's (forward, decode) on a mesh: forward (tp, p, cfg,
# x, state, token_mask) from the init state, decode (tp, p, cfg, x, state)
# from the rows' state; `state` the layer's cache leaves as `Local`s (their
# layout), and each returns (y, this rank's new state)
MESH_RECURRENT = {
    "mamba": (mb.mamba_forward_mesh, mb.mamba_decode_mesh),
    "mlstm": (xl.mlstm_forward_mesh, xl.mlstm_decode_mesh),
    "slstm": (xl.slstm_forward_mesh, xl.slstm_decode_mesh),
}


def _apply_layer_mesh(tp, cfg, sig, p, x, positions, cache, pos, token_mask, tiered_state,
                      cold_capacity_frac, train: bool = False, enc_out=None):
    """`apply_layer` on a mesh, contiguous layout (x this rank's rows,
    every `Local` leaf this rank's shard; a recurrent layer's new state
    written over its shard in place): (x, aux loss or None, expert counts
    [E] or None). With `train` the cacheless full mode: `cache` holds a
    recurrent layer's state layout only (meta `Local`s), nothing is
    written, cross attention projects K / V from the encoder output
    `enc_out`, and the flat MoE runs at the config's capacity factor."""
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.serving.tiered_moe import tiered_moe_forward_mesh

    mixer, ffn = sig
    h = rmsnorm(tpl.whole(p["norm1"]), x, cfg.norm_eps)
    if mixer in MESH_RECURRENT:
        forward, decode = MESH_RECURRENT[mixer]
        state = cache["state"]
        y, new = (decode(tp, p["mixer"], cfg, h, state) if pos is not None
                  else forward(tp, p["mixer"], cfg, h, state, token_mask))
        if not train:
            for key, val in new.items():
                state[key].t.copy_(val)
    elif train:
        fn = {"attn": attn.gqa_prefill_mesh, "mla": attn.mla_prefill_mesh}[mixer]
        y = fn(tp, p["mixer"], cfg, h, positions, token_mask)
    else:
        a, b = (cache[key] for key in MIXERS[mixer].cache_shapes(cfg, 0))
        fn = {("attn", True): attn.gqa_decode_mesh, ("mla", True): attn.mla_decode_mesh,
              ("attn", False): attn.gqa_prefill_mesh, ("mla", False): attn.mla_prefill_mesh}
        if pos is not None:
            y = fn[mixer, True](tp, p["mixer"], cfg, h, a, b, pos)
        else:
            y = fn[mixer, False](tp, p["mixer"], cfg, h, positions, token_mask, a, b)
    x = x + y
    if "cross" in p:
        hc = rmsnorm(tpl.whole(p["norm_cross"]), x, cfg.norm_eps)
        x = x + (attn.cross_attention_train_mesh(tp, p["cross"], cfg, hc, enc_out) if train
                 else attn.cross_attention_mesh(tp, p["cross"], cfg, hc, cache["ck"],
                                                cache["cv"]))
    aux = counts = None
    if ffn != "none":
        h2 = rmsnorm(tpl.whole(p["norm2"]), x, cfg.norm_eps)
        if ffn == "moe" and tiered_state is not None:
            y, counts = tiered_moe_forward_mesh(tp, p["ffn"], tiered_state, cfg, h2,
                                                cold_capacity_frac, token_mask)
        elif ffn == "moe":
            out = moe_lib.moe_forward_mesh(tp, p["ffn"], cfg, h2,
                                           full_capacity=pos is not None or token_mask is not None,
                                           token_mask=token_mask)
            y, aux, counts = out.y, out.aux_loss, out.expert_counts
        else:
            y = tpl.mlp(tp, p["ffn"], h2)
        x = x + y
    return x, aux, counts


def _mesh_local(tp, params, cache, tiered):
    """(params, cache, tiered) as trees of `Local` leaves."""
    from repro_torch.distributed import tensor_parallel as tpl

    return (tpl.local_tree(params, tp.mesh), tpl.local_tree(cache, tp.mesh),
            None if tiered is None else tpl.local_tree(tiered, tp.mesh))


def _mesh_walk(tp, cfg, local, x, positions, pos, token_mask, cold_capacity_frac):
    """Every layer in execution order on the mesh over the `Local` trees
    (params, cache, tiered): (x, counts [n_layers, E])."""
    e = cfg.moe.n_experts if cfg.moe is not None else 1
    no_moe = torch.zeros((e,), dtype=torch.int32, device=x.device)
    counts_all = []
    for sig, p, c, ts in _layers(local[0], cfg, local[1], local[2]):
        x, _, counts = _apply_layer_mesh(tp, cfg, sig, p, x, positions, c, pos, token_mask, ts,
                                         cold_capacity_frac)
        counts_all.append(no_moe if counts is None else counts)
    return x, torch.stack(counts_all)


def _mesh_logits(tp, params, cfg, x):
    from repro_torch.distributed import tensor_parallel as tpl

    x = rmsnorm(tpl.whole(params["final_norm"]), x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return tpl.out_proj(tp, x, params["embed"]["table"], transpose=True)
    return tpl.out_proj(tp, x, params["head"]["w"])


def _mesh_encoder(tp, params, cfg, frames, remat: bool = False):
    """`_run_encoder` on a mesh over this rank's rows of frames [B, F, D]:
    each layer's self-attention heads-parallel (non-causal, RoPE at the
    frames' positions), its FFN column- then row-parallel. With `remat`
    (training) each layer is activation-checkpointed."""
    from repro_torch.distributed import tensor_parallel as tpl

    enc = params["encoder"]
    positions = torch.arange(frames.shape[1], dtype=torch.int32, device=frames.device)[None, :]

    def layer(p, x):
        h = rmsnorm(tpl.whole(p["norm1"]), x, cfg.norm_eps)
        x = x + attn.gqa_prefill_mesh(tp, p["mixer"], cfg, h, positions, None, causal=False)
        return x + tpl.mlp(tp, p["ffn"], rmsnorm(tpl.whole(p["norm2"]), x, cfg.norm_eps))

    x = frames
    for p in tpl.unbind_locals(enc["stack"]["slot0"]):
        x = checkpoint(layer, p, x, use_reentrant=False) if remat else layer(p, x)
    return rmsnorm(tpl.whole(enc["final_norm"]), x, cfg.norm_eps)


def _train_states(tp, cfg):
    """The recurrent layers' state layout as the rules place a cache of the
    global batch (`cache_pspecs`), in the cache tree's layout: meta
    `Local`s, which say how "model" splits each layer's channels and hold
    no storage (training runs every layer from its init state)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tpl

    like = init_states(cfg, tp.batch, device="meta")
    return tpl.spec_locals(like, shd.cache_pspecs(like, tp.mesh), tp.mesh)


def mesh_forward_train(tp, params, cfg: ModelConfig, batch):
    """`forward_train` on a device mesh, GSPMD's partitioning of the
    reference's training forward written out (distributed/tensor_parallel.py),
    differentiable through every collective: `params` a tree of `Local`s
    (this rank's shards), batch {"tokens", and "frames"} this rank's rows
    of the global batch of `tp.batch` rows. The embedding is vocab-
    parallel (or D-split), attention heads-parallel (query rows split
    over "model" where the heads do not divide), the MLPs column- then
    row-parallel, Mamba and xLSTM channel-parallel as the rules split
    their state, the flat MoE as `moe_forward_mesh` places it at the
    config's capacity factor. Each scan group (and each encoder layer) is
    activation-checkpointed, non-reentrant: its weights' FSDP gathers and
    broadcasts run inside it and again in its recompute. Returns (this
    rank's logits: its vocab columns from index `lo` (`tpl.out_proj`'s
    `keep_cols`: a vocab-split head's, or a D-split head's partial sums
    reduce-scattered over the padded vocab), else [B/dp, S, V] with lo
    None; the aux loss (the whole batch's on every rank, its gradient
    this rank's part); the expert counts [n_groups * period, E] int32 of
    the whole batch, stacked as `forward_train` stacks them)."""
    from repro_torch.distributed import tensor_parallel as tpl

    tokens = batch["tokens"]
    unrolled_idx, n_groups, period = stack_plan(cfg)
    x = tpl.embed(tp, params["embed"]["table"], tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)[None, :]
    e = cfg.moe.n_experts if cfg.moe is not None else 1
    no_moe = torch.zeros((e,), dtype=torch.int32, device=x.device)
    enc_out = None
    if cfg.encdec is not None:
        check_frames(params, cfg, batch.get("frames"))
        enc_out = _mesh_encoder(tp, params, cfg, batch["frames"], remat=True)
    states = _train_states(tp, cfg)

    def layer(sig, p, st, x, enc_out):
        return _apply_layer_mesh(tp, cfg, sig, p, x, positions, st, None, None, None, 0.0,
                                 train=True, enc_out=enc_out)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in unrolled_idx:
        x, aux, _ = layer(layer_signature(cfg, li), params[f"layer{li}"],
                          states[f"layer{li}"], x, enc_out)
        aux_total = aux_total if aux is None else aux_total + aux

    def group(x, aux_sum, p, st, enc_out):
        counts = []
        for j, sig in enumerate(period):
            x, aux, c = layer(sig, p[f"slot{j}"], st[f"slot{j}"], x, enc_out)
            aux_sum = aux_sum if aux is None else aux_sum + aux
            counts.append(no_moe if c is None else c)
        return x, aux_sum, torch.stack(counts)

    counts_all = []
    for g, p in enumerate(tpl.unbind_locals(params["stack"])):
        x, aux_total, counts = checkpoint(group, x, aux_total, p, index_tree(states["stack"], g),
                                          enc_out, use_reentrant=False)
        counts_all.append(counts)
    x = rmsnorm(tpl.whole(params["final_norm"]), x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits, lo = tpl.out_proj(tp, x, params["embed"]["table"], transpose=True,
                                  keep_cols=True)
    else:
        logits, lo = tpl.out_proj(tp, x, params["head"]["w"], keep_cols=True)
    return logits, lo, aux_total, torch.cat(counts_all)


def _mesh_prefill(params, cfg, tokens, cache_len, tiered, cold_capacity_frac, token_mask, mesh,
                  frames=None, batch=None):
    """`prefill` on a device mesh, GSPMD's partitioning of the reference's
    one program written out (distributed/tensor_parallel.py): params (and
    tiered, when given) are DTensor trees under `tree_pspecs` /
    `tiered_pspecs`, tokens [B/dp, S] this rank's rows of the global batch
    of `batch` rows (default B/dp times the DP size), split over the DP
    axes, pod-major (`shard_rows`); a batch that does not split comes
    whole to every rank, which computes all of it (`TP`). The embedding is
    vocab-parallel (or D-split), attention heads tensor-parallel, the
    MLPs column- then row-parallel, Mamba and xLSTM channel-parallel over
    their state's split (models/mamba.py, models/xlstm.py), the MoE as
    `moe_forward_mesh` / `tiered_moe_forward_mesh` place it, the logits
    gathered over "model". An encoder-decoder model runs its encoder over
    this rank's rows of `frames` and writes each layer's cross K/V into
    its frame shards. Returns (this rank's rows' logits [B/dp, V], the
    cache as DTensors under `cache_pspecs`: this rank's rows and shard)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tpl

    b, s = tokens.shape
    tp = tpl.TP(mesh, b * shd.dp_size(mesh) if batch is None else batch)
    if b * tp.n_dp != tp.batch:
        raise ValueError(f"{b} rows a rank on {tp.n_dp} DP shards, for a batch of {tp.batch}")
    like = init_cache(cfg, tp.batch, cache_len or s, device="meta")
    cache = shd.sharded_zeros(like, shd.cache_pspecs(like, mesh), mesh, tokens.device)
    local = _mesh_local(tp, params, cache, tiered)
    if cfg.encdec is not None:
        check_frames(params, cfg, frames)
        enc_out = _mesh_encoder(tp, local[0], cfg, frames)
        for _, lp, c, _ in _layers(local[0], cfg, local[1], None):
            attn.fill_cross_mesh(tp, lp["cross"], enc_out, c["ck"], c["cv"])
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    x = tpl.embed(tp, local[0]["embed"]["table"], tokens)
    x, _ = _mesh_walk(tp, cfg, local, x, positions, None, token_mask, cold_capacity_frac)
    return _mesh_logits(tp, local[0], cfg, _last_real(x, token_mask))[:, 0], cache


def _cache_batch(cache) -> int:
    """The global batch's rows of a cache tree (DTensors: whole shapes)."""
    from repro_torch.tree import leaves_with_path

    path, leaf = next(iter(leaves_with_path(cache)))
    return leaf.shape[1 if path[0] == "stack" else 0]


def _mesh_decode(params, cfg, tokens, cache, pos, tiered, cold_capacity_frac, token_mask,
                 mesh):
    """`decode_step` on a device mesh (see `_mesh_prefill`): tokens [B/dp,
    1], pos and token_mask this rank's rows', cache its DTensors (written
    in place; their global batch says whether the rows split). Returns
    (logits [B/dp, V], cache, expert_counts [n_layers, E] summed over the
    DP shards: the whole batch's)."""
    from repro_torch.distributed import tensor_parallel as tpl

    tp = tpl.TP(mesh, _cache_batch(cache))
    pos = _row_positions(pos, tokens)
    tmask = None if token_mask is None else token_mask.reshape(-1, 1)
    local = _mesh_local(tp, params, cache, tiered)
    x = tpl.embed(tp, local[0]["embed"]["table"], tokens)
    x, counts = _mesh_walk(tp, cfg, local, x, pos[:, None], pos, tmask, cold_capacity_frac)
    return _mesh_logits(tp, local[0], cfg, x)[:, 0], cache, counts


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
    check_decoder_only(cfg, "the paged layout")
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
    check_decoder_only(cfg, "paged prefill")
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
    check_decoder_only(cfg, "paged verify")
    if is_recurrent(cfg):
        raise ValueError(
            "decode_verify requires an attention-only arch: a verify chunk "
            "cannot thread the rows' recurrent state"
        )
    x, counts, _ = _chunk(params, cfg, tokens, pools, tables, past_len, token_mask, tiered,
                       cold_capacity_frac)
    return _logits(params, cfg, x), pools, counts
