"""The contiguous ("slots") layout of the PyTorch port against the JAX
package, at fp32 on bridged smoke weights and the same seeded numpy
inputs: `_grouped_attention`, `gqa_forward` / `gqa_decode` / `mla_forward`
/ `mla_decode` (ring wrap, rows at mixed positions), `prefill` (exact and
masked) and `decode_step` (logits, expert counts, cache rows),
`SlotKVCache`, and the engine's `prefill_slots` / `step_slots` / `step`.

Tolerance 1e-5 (absolute and relative) everywhere: both packages run the
same fp32 arithmetic, so only the order of fp32 summations differs.
Expert counts and tokens are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models import attention as jattn
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params
from repro.models.model import prefill as jax_prefill
from repro.serving.engine import TriMoEServingEngine as JaxEngine
from repro.serving.engine import fill_tiers_from_params as jax_fill_tiers
from repro.serving.engine import init_tiered_for_model as jax_init_tiered
from repro.serving.kv_cache import SlotKVCache as JaxSlotKVCache
from repro_torch.bridge import to_torch
from repro_torch.models import attention as tattn
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.serving.engine import TriMoEServingEngine
from repro_torch.serving.kv_cache import SlotKVCache
from repro_torch.serving.tiered_moe import TierSizes

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
TOL = dict(atol=1e-5, rtol=1e-5)
_SMOKE = {}


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _smoke(arch):
    """(JAX config, port config, host (params, tiered)) of an fp32 smoke
    config, built once per arch."""
    if arch not in _SMOKE:
        jcfg = _f32(reduce_for_smoke(get_config(arch)))
        tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(arch)))
        params = jax_init_params(jax.random.PRNGKey(0), jcfg)
        tiered = jax_fill_tiers(
            params, jax_init_tiered(jax.random.PRNGKey(1), jcfg, TierSizes(2, 2, 4)), jcfg)
        _SMOKE[arch] = jcfg, tcfg, jax.tree.map(np.asarray, (params, tiered))
    return _SMOKE[arch]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _same_cache(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=path, **(tol or TOL))


def _layer_params(arch, mixer_slot="slot0"):
    jcfg, tcfg, (params, _) = _smoke(arch)
    p = jax.tree.map(lambda a: a[0], params["stack"][mixer_slot]["mixer"])
    return jcfg, tcfg, p


# ------------------------------------------------- grouped attention
@pytest.mark.parametrize("case", ["causal", "causal_valid", "row_valid", "q_chunks"])
def test_grouped_attention_matches(case):
    rng = np.random.default_rng(0)
    b, sq, sk, h, kvh, hd = 2, 6, 6, 4, 2, 8
    if case == "row_valid":
        sq = 1  # decode: one query against a ring of per-row valid keys
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    kw = {}
    if case in ("causal", "causal_valid", "q_chunks"):
        kw["causal"] = True
    if case == "causal_valid":
        kw["valid"] = np.arange(sk)[None, :] < np.array([[6], [4]])  # per-row pads
    if case == "row_valid":
        kw["valid"] = np.arange(sk)[None, :] <= np.array([[2], [5]])
    if case == "q_chunks":
        kw["q_chunk"] = 2  # three query chunks
    jk = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_ for k_, v_ in kw.items()}
    tk = {k_: torch.tensor(v_) if isinstance(v_, np.ndarray) else v_ for k_, v_ in kw.items()}
    want = jattn._grouped_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jk)
    got = tattn._grouped_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **tk)
    _close(got, want)


# ------------------------------------------------------- mixers
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_with_pad_keys(arch):
    """gqa_forward (granite) / mla_forward (deepseek, expanded K/V): real
    rows' outputs and the tokens' cache entries, with right-padded rows."""
    jcfg, tcfg, p = _layer_params(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, jcfg.d_model)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([[7], [4], [1]])
    positions = np.arange(7, dtype=np.int32)[None, :]
    jf = jattn.mla_forward if arch.startswith("deepseek") else jattn.gqa_forward
    tf = tattn.mla_forward if arch.startswith("deepseek") else tattn.gqa_forward
    jy, jc = jf(p, jcfg, jnp.asarray(x), jnp.asarray(positions), token_mask=jnp.asarray(mask))
    ty, tc = tf(to_torch(p), tcfg, torch.tensor(x), torch.tensor(positions),
                token_mask=torch.tensor(mask))
    _close(ty[torch.tensor(mask)], np.asarray(jy)[mask])
    for a, b in zip(tc, jc):
        _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pos", [[3, 9], [11, 22]], ids=["mixed", "ring_wrap"])
def test_decode_matches_at_mixed_positions_and_ring_wrap(arch, pos):
    """gqa_decode / mla_decode on an 8-slot ring: rows at different
    positions, and positions past the ring (the write lands at pos % S
    and every slot is valid)."""
    jcfg, tcfg, p = _layer_params(arch)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    if arch.startswith("deepseek"):
        m = jcfg.mla
        shapes = [(2, 8, m.kv_lora_rank), (2, 8, m.qk_rope_head_dim)]
        jf, tf = jattn.mla_decode, tattn.mla_decode
    else:
        shapes = [(2, 8, jcfg.n_kv_heads, jcfg.resolved_head_dim)] * 2
        jf, tf = jattn.gqa_decode, tattn.gqa_decode
    ca, cb = (rng.normal(size=s).astype(np.float32) for s in shapes)
    posv = np.array(pos, np.int32)
    jy, ja, jb = jf(p, jcfg, jnp.asarray(x), jnp.asarray(ca), jnp.asarray(cb),
                    jnp.asarray(posv))
    ta, tb = torch.tensor(ca), torch.tensor(cb)
    ty, ra, rb = tf(to_torch(p), tcfg, torch.tensor(x), ta, tb, torch.tensor(posv))
    assert ra is ta and rb is tb  # written in place
    _close(ty, jy)
    _close(ta, ja)
    _close(tb, jb)


# ------------------------------------------------- prefill / decode_step
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True], ids=["exact", "masked"])
def test_prefill_then_decode_step_match(arch, masked):
    """prefill (exact-length, or right-padded with a token mask: pad cache
    entries zeroed, logits at each row's last real token) then two decode
    steps with a dead row: logits, per-layer expert counts and every cache
    row, through the tiered MoE runtime."""
    jcfg, tcfg, (params, tiered) = _smoke(arch)
    rng = np.random.default_rng(3)
    b, s, cache_len = 3, 6, 10
    toks = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    lens = np.array([6, 4, 2] if masked else [s] * b, np.int32)
    mask = np.arange(s)[None, :] < lens[:, None]
    jl, jcache = jax_prefill(params, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=cache_len,
                             tiered=tiered, cold_capacity_frac=1.0,
                             token_mask=jnp.asarray(mask) if masked else None)
    tp, tt = to_torch(params), to_torch(tiered)
    tl, tcache = prefill(tp, tcfg, torch.tensor(toks), cache_len=cache_len, tiered=tt,
                         cold_capacity_frac=1.0, token_mask=torch.tensor(mask) if masked else None)
    _close(tl, jl)
    _same_cache(tcache, jcache)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    pos = lens.copy()
    live = np.array([True, False, True])
    for _ in range(2):
        jl, jcache, jc = jax_decode_step(params, jcfg, jnp.asarray(nxt), jcache,
                                         jnp.asarray(pos), tiered=tiered,
                                         cold_capacity_frac=1.0, token_mask=jnp.asarray(live))
        tl, tcache, tc = decode_step(tp, tcfg, torch.tensor(nxt), tcache, torch.tensor(pos),
                                     tiered=tt, cold_capacity_frac=1.0,
                                     token_mask=torch.tensor(live))
        _close(tl, jl)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        _same_cache(tcache, jcache)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1


def test_init_cache_keeps_the_jax_tree():
    for arch in ARCHS:
        jcfg, tcfg, _ = _smoke(arch)
        want = {k: v.shape for k, v in _flat(jax_init_cache(jcfg, 3, 5)).items()}
        got = {k: v.shape for k, v in _flat(init_cache(tcfg, 3, 5)).items()}
        assert got == want


# --------------------------------------------------------- SlotKVCache
def test_slot_kv_cache_matches_jax_and_refuses_a_double_free():
    """The same allocate / claim / scatter / free sequence leaves the same
    free list and the same cache rows (freed rows zeroed, the scan-group
    axis respected); a double free and an out-of-range free assert."""
    jcfg, tcfg, _ = _smoke("deepseek-v2-236b")  # unrolled dense layer 0 + stack
    jkv, tkv = JaxSlotKVCache(jcfg, 4, 6), SlotKVCache(tcfg, 4, 6, device="cpu")
    rng = np.random.default_rng(4)
    sub = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                       jax.tree.map(np.asarray, jkv.gather([0, 1])))
    assert jkv.allocate() == tkv.allocate() == 0
    jkv.claim(2)
    tkv.claim(2)
    jkv.scatter(jax.tree.map(jnp.asarray, sub), [2, 0])
    tkv.scatter(to_torch(sub), [2, 0])
    _same_cache(tkv.cache, jkv.cache)
    _same_cache(tkv.gather([0, 2]), jkv.gather([0, 2]))
    jkv.free([2])
    tkv.free([2])
    _same_cache(tkv.cache, jkv.cache)
    assert tkv._free == jkv._free and tkv.n_free == jkv.n_free == 3
    with pytest.raises(AssertionError, match="double free"):
        tkv.free([2])
    with pytest.raises(AssertionError, match="double free"):
        tkv.free([7])
    with pytest.raises(AssertionError, match="not free"):
        tkv.claim(0)


# -------------------------------------------------------------- engine
def _engines(arch, prefill_rows=2):
    jcfg, tcfg, (params, tiered) = _smoke(arch)
    kw = dict(sizes=TierSizes(2, 2, 4), cold_capacity_frac=1.0, prefill_rows=prefill_rows)
    je = JaxEngine(jcfg, params, JaxSlotKVCache(jcfg, 4, 12),
                   jax.tree.map(jnp.asarray, tiered), **kw)
    te = TriMoEServingEngine(tcfg, to_torch(params), SlotKVCache(tcfg, 4, 12, device="cpu"),
                             to_torch(tiered), **kw)
    return jcfg, je, te


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_prefill_slots_step_slots_and_step_match(arch):
    """Masked prefill_slots of 3 rows at prefill_rows=2 (a call with one
    dummy row, which must not reach slot 0), step_slots of a group with a
    dead row, exact-length prefill_slots, then the full-batch `step` with
    its synchronous replan: logits, counts, cache rows, tier state and
    engine stats as the JAX engine's."""
    jcfg, je, te = _engines(arch)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jcfg.vocab_size, size=(3, 8)).astype(np.int32)
    lens = np.array([8, 3, 5], np.int32)
    slots = [2, 3, 1]
    jl = je.prefill_slots(prompts, slots, lengths=lens)
    tl = te.prefill_slots(prompts, slots, lengths=lens)
    _close(tl, jl)
    _same_cache(te.cache, je.cache)
    for path, a in _flat(te.cache).items():  # the dummy row did not reach slot 0
        assert not (a[:, 0] if path.startswith("stack") else a[0]).any(), path
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    idx, live = [1, 2, 3, 0], np.array([True, True, True, False])
    toks = np.concatenate([tok[[2, 0, 1]], np.zeros((1, 1), np.int32)])
    pos = np.array([5, 8, 3, 0], np.int32)
    jl, jc = je.step_slots(toks, pos, idx, live=live)
    tl, tc = te.step_slots(toks, pos, idx, live=live)
    _close(tl, jl)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _same_cache(te.cache, je.cache)

    one = rng.integers(0, jcfg.vocab_size, size=(1, 6)).astype(np.int32)
    _close(te.prefill_slots(one, [0]), je.prefill_slots(one, [0]))
    _same_cache(te.cache, je.cache)
    full = rng.integers(0, jcfg.vocab_size, size=(4, 1)).astype(np.int32)
    _close(te.step(full, 9), je.step(jnp.asarray(full), 9))
    _same_cache(te.cache, je.cache)
    _same_cache(te.tiered, jax.tree.map(np.asarray, je.tiered))
    for name in ("steps", "prefills", "prefill_tokens", "replans", "migrations"):
        assert getattr(te.stats, name) == getattr(je.stats, name), name


def test_engine_wraps_a_raw_cache():
    """A raw contiguous cache tree is wrapped as a SlotKVCache with every
    slot allocated, as the reference's constructor does."""
    jcfg, tcfg, (params, tiered) = _smoke("granite-moe-1b-a400m")
    raw = init_cache(tcfg, 2, 4)
    te = TriMoEServingEngine(tcfg, to_torch(params), raw, to_torch(tiered),
                             sizes=TierSizes(2, 2, 4))
    assert isinstance(te.kv, SlotKVCache) and te.kv.n_slots == 2 and te.kv.n_free == 0
    assert te.cache is raw
