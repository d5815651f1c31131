"""Serving-level parity of the port on a recurrent arch: jamba-v0.1-52b
(Mamba + GQA + MoE, one attention layer and MoE every other layer),
against the JAX `ServingLoop`.

At fp32, on the same bridged params and tier state, the smoke config
serves a staggered shared-prefix request set with IDENTICAL tokens in
the paged default (which admits whole suffixes by itself: a recurrent
arch turns chunked prefill and the radix index off), over the
contiguous `kv_layout="slots"` cache and with exact-length prefill
(`bucket_table=None`), with equal replan and migration counts and
prefill rows. The per-slot recurrent state is counted in the byte
accounting that sizes the tiers, at its own dtype, as the reference
counts it; and speculative decode and chunk-of-k verification refuse
a recurrent arch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models.model import init_params as jax_init_params
from repro.serving.batching import Request as JaxRequest
from repro.serving.kv_cache import cache_bytes as jax_cache_bytes
from repro.serving.loop import ServingLoop as JaxServingLoop
from repro.serving.paged_kv import PagedKVCache as JaxPagedKVCache
from repro.serving.tiered_moe import tier_sizes as jax_tier_sizes
from repro_torch.bridge import to_torch
from repro_torch.launch import serve as tserve
from repro_torch.models.model import init_params
from repro_torch.serving.batching import Request
from repro_torch.serving.kv_cache import cache_bytes
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.tiered_moe import TierSizes, tier_sizes

ARCH = "jamba-v0.1-52b"
MODES = {
    "paged": {},
    "slots": dict(kv_layout="slots"),
    "exact": dict(bucket_table=None),
}


def _cfgs(dtype="float32", n_layers=None):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    if n_layers is None:
        return (dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **kw),
                dataclasses.replace(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)), **kw))
    kw["n_layers"] = n_layers
    return (dataclasses.replace(get_config(ARCH), **kw),
            dataclasses.replace(tcfgs.get_config(ARCH), **kw))


def _requests(vocab):
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 8)
    return [(rid, np.concatenate([system, rng.integers(0, vocab, 3 + rid % 5)])
             .astype(np.int32), 6) for rid in range(6)]


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = _cfgs()
    return jcfg, tcfg, jax_init_params(jax.random.PRNGKey(0), jcfg)


def _loops(smoke, **kw):
    jcfg, tcfg, params = smoke
    kw = dict(batch_size=4, n_groups=2, cache_len=24, **kw)
    jl = JaxServingLoop(jcfg, params, **kw)
    tiered = jax.tree.map(np.asarray, jl.engine.tiered)
    tl = ServingLoop(tcfg, to_torch(jax.tree.map(np.asarray, params)), to_torch(tiered),
                     sizes=TierSizes(*jl.engine.sizes), device="cpu", **kw)
    return jl, tl


@pytest.mark.parametrize("mode", list(MODES))
def test_jamba_serving_tokens_identical_to_jax(smoke, mode):
    jl, tl = _loops(smoke, **MODES[mode])
    assert tl.paged == jl.paged and tl.chunked is jl.chunked is False
    if tl.paged:
        assert tl.kv.radix is None and jl.kv.radix is None
    reqs = _requests(smoke[0].vocab_size)
    for rid, prompt, n in reqs:
        jl.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        tl.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.generated for r in jl.run(max_steps=500)}
    got = {r.rid: r.generated for r in tl.run(max_steps=500)}
    assert len(got) == len(reqs) and all(len(t) == 6 for t in got.values())
    assert got == want
    assert tl.stats.replans == jl.stats.replans > 0
    assert tl.stats.migrations == jl.stats.migrations > 0
    assert tl.stats.prefill_chunks == jl.stats.prefill_chunks == 0
    assert tl.engine.stats.prefills == jl.engine.stats.prefills == len(reqs)
    assert tl.engine.stats.prefill_tokens == jl.engine.stats.prefill_tokens


def test_serve_driver_runs_jamba_on_cpu(capsys):
    """`--arch jamba-v0.1-52b --smoke --device cpu`: every request completes
    with no prefill chunk (whole-suffix admission) and no prefix hit."""
    assert tserve.main(["--arch", ARCH, "--smoke", "--requests", "4", "--batch", "2",
                        "--groups", "1", "--new-tokens", "4", "--device", "cpu"]) == 16
    out = capsys.readouterr().out
    assert "4/4 requests" in out and "prefill_chunks=0" in out
    assert "prefix_hit_rate=0.000" in out


def test_spec_decode_and_verify_refuse_jamba(smoke):
    """The loop's spec gate raises the reference's assertion; below it the
    engine's chunk-of-k verify raises for the recurrent arch too (the
    reference would restart its recurrent layers from the zero state)."""
    jcfg, tcfg, params = smoke
    with pytest.raises(AssertionError, match="attention-only"):
        JaxServingLoop(jcfg, params, batch_size=2, cache_len=16, spec_decode=True)
    tparams = init_params(0, tcfg, device="cpu")
    with pytest.raises(AssertionError, match="attention-only"):
        ServingLoop(tcfg, tparams, batch_size=2, cache_len=16, spec_decode=True,
                    device="cpu")
    tl = ServingLoop(tcfg, tparams, batch_size=2, cache_len=16, device="cpu")
    tl.kv.admit_slot(0, np.arange(5))
    with pytest.raises(ValueError, match="attention-only"):
        tl.engine.verify_slots_paged(np.zeros((2, 2), np.int32), [0, 1],
                                     np.array([2, 1]), np.array([5, 0]),
                                     live=np.array([True, False]))


def test_prefill_scatters_real_rows_only(smoke):
    """A paged admission of one row into slot 2 (padded with dummy rows to
    `prefill_rows`) writes slot 2's recurrent state and leaves every other
    slot, slot 0 included, at its init state."""
    _, tl = _loops(smoke)
    before = [t.clone() for t in _state_leaves(tl.kv.slot_state)]
    tl.kv.admit_slot(2, np.arange(7))
    tl.engine.prefill_slots_paged(np.arange(8, dtype=np.int32)[None], [2], np.array([7]),
                                  np.array([0]))
    after = list(_state_leaves(tl.kv.slot_state))
    assert after
    for b, a in zip(before, after):
        others = [s for s in range(4) if s != 2]
        assert torch.equal(a[:, others], b[:, others])
    assert any(not torch.equal(a[:, 2], b[:, 2]) for b, a in zip(before, after))


def _state_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _state_leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_byte_accounting_and_tier_sizes_match_jax(dtype):
    """`cache_bytes`, `paged_bytes` and `reclaimed_bytes` count every leaf
    at its own dtype (the SSM state fp32 under bf16 params), as the
    reference does, and the tiers each loop derives from them are equal:
    at the smoke config (both layouts) and at published widths with the
    8 layers the H100 serves (whose sizing depends on the reclaimed
    bytes)."""
    jcfg, tcfg = _cfgs(dtype)
    for batch, seq in ((4, 24), (8, 72)):
        assert cache_bytes(tcfg, batch, seq) == jax_cache_bytes(jcfg, batch, seq)
        jkv = JaxPagedKVCache(jcfg, batch, seq, block_size=4)
        tkv = PagedKVCache(tcfg, batch, seq, block_size=4, device="cpu")
        assert tkv.paged_bytes() == jkv.paged_bytes()
        assert tkv.reclaimed_bytes(seq) == jkv.reclaimed_bytes(seq)
        assert tkv.radix is None and jkv.radix is None
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = init_params(0, tcfg, device="cpu")
    for layout in ("paged", "slots"):
        jl = JaxServingLoop(jcfg, params, batch_size=4, cache_len=24, kv_layout=layout)
        tl = ServingLoop(tcfg, tparams, batch_size=4, cache_len=24, kv_layout=layout,
                         device="cpu")
        assert tuple(tl.engine.sizes) == tuple(jl.engine.sizes), layout
    jfull, tfull = _cfgs(dtype, n_layers=8)
    assert cache_bytes(tfull, 8, 72) == jax_cache_bytes(jfull, 8, 72)
    jkv = JaxPagedKVCache(jfull, 8, 72, block_size=4)
    tkv = PagedKVCache(tfull, 8, 72, block_size=4, device="cpu")
    assert tkv.paged_bytes() == jkv.paged_bytes()
    reclaimed = tkv.reclaimed_bytes(72)
    assert reclaimed == jkv.reclaimed_bytes(72)
    assert (tuple(tier_sizes(tfull, reclaimed_kv_bytes=reclaimed))
            == tuple(jax_tier_sizes(jfull, reclaimed_kv_bytes=reclaimed)))
