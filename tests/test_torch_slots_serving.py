"""Serving-level parity of the port's whole-suffix admission prefill
against the JAX `ServingLoop`: the contiguous `kv_layout="slots"` layout,
paged KV with `chunked_prefill=False`, each with bucketed masked prefill
and with the exact-length path (`bucket_table=None`).

At fp32, on the same bridged params and tier state, a staggered
shared-prefix request set generates IDENTICAL tokens for every request,
with equal replan and migration counts, prefill rows and prefill chunks
(none: every admission prefills its whole uncached suffix at once) and,
under paged KV, the same prefix hit rate; for a GQA (granite) and an MLA
(deepseek) model.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models.model import init_params as jax_init_params
from repro.serving.batching import Request as JaxRequest
from repro.serving.loop import ServingLoop as JaxServingLoop
from repro_torch.bridge import to_torch
from repro_torch.serving.batching import Request
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.tiered_moe import TierSizes

MODES = {
    "slots": dict(kv_layout="slots"),
    "slots_exact": dict(kv_layout="slots", bucket_table=None),
    "nochunk": dict(chunked_prefill=False),
    "nochunk_exact": dict(chunked_prefill=False, bucket_table=None),
}


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _requests(vocab):
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 8)
    return [(rid, np.concatenate([system, rng.integers(0, vocab, 3 + rid % 5)])
             .astype(np.int32), 6) for rid in range(8)]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_whole_suffix_serving_tokens_identical_to_jax(arch, mode):
    jcfg = _f32(reduce_for_smoke(get_config(arch)))
    tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(arch)))
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    kw = dict(batch_size=4, n_groups=2, cache_len=24, **MODES[mode])
    jl = JaxServingLoop(jcfg, params, **kw)
    tiered = jax.tree.map(np.asarray, jl.engine.tiered)
    tl = ServingLoop(tcfg, to_torch(jax.tree.map(np.asarray, params)), to_torch(tiered),
                     sizes=TierSizes(*jl.engine.sizes), device="cpu", **kw)
    assert tl.paged == jl.paged and tl.chunked is jl.chunked is False
    reqs = _requests(jcfg.vocab_size)
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
    if tl.paged:
        assert tl.kv.stats.hit_rate == jl.kv.stats.hit_rate > 0


def test_slots_default_tier_split_is_the_references():
    """Without explicit sizes the slots layout splits the tiers as the JAX
    loop does (`_default_sizes`), the paged layout by `tier_sizes`."""
    for arch in ("granite-moe-1b-a400m", "deepseek-v2-236b"):
        jcfg = reduce_for_smoke(get_config(arch))
        tcfg = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
        for layout in ("slots", "paged"):
            jl = JaxServingLoop(jcfg, jax_init_params(jax.random.PRNGKey(0), jcfg),
                                batch_size=2, cache_len=16, kv_layout=layout)
            from repro_torch.models.model import init_params

            tl = ServingLoop(tcfg, init_params(0, tcfg, device="cpu"), batch_size=2,
                             cache_len=16, kv_layout=layout, device="cpu")
            assert tuple(tl.engine.sizes) == tuple(jl.engine.sizes), (arch, layout)
