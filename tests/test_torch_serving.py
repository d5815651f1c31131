"""Serving-level parity of the PyTorch port (`ServingLoop(device="cpu")`)
against the JAX `ServingLoop`, plus the port's paged-KV bookkeeping and
its device rule.

The flagship gate: at fp32, on the same bridged params AND tier state
(the cold buffer's random padding slots included, which migrations may
move), a staggered shared-prefix request set served with the defaults
(paged KV, radix prefix reuse, chunked piggyback prefill) generates
IDENTICAL tokens for every request, with equal replan and migration
counts, prefill chunks and prefix hit rate, for a GQA (granite) and an
MLA (deepseek) model. The KV sanitizer is on for both loops
(tests/conftest.py sets REPRO_KV_SANITIZE=1).
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
from repro.serving.loop import ServingLoop as JaxServingLoop
from repro_torch.bridge import to_torch
from repro_torch.launch import serve as tserve
from repro_torch.serving.batching import Request
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.paged_kv import PagedKVCache, RadixPrefixIndex
from repro_torch.serving.tiered_moe import TierSizes

ARCH = "granite-moe-1b-a400m"


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _requests(vocab):
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 8)
    return [(rid, np.concatenate([system, rng.integers(0, vocab, 3 + rid % 5)])
             .astype(np.int32), 6) for rid in range(8)]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_port_serving_loop_tokens_identical_to_jax(arch):
    """granite: GQA attention; deepseek: MLA latent pools, a dense first
    layer and shared experts."""
    jcfg = _f32(reduce_for_smoke(get_config(arch)))
    tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(arch)))
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    kw = dict(batch_size=4, n_groups=2, cache_len=24, prefill_chunk_tokens=8)
    jl = JaxServingLoop(jcfg, params, **kw)
    tiered = jax.tree.map(np.asarray, jl.engine.tiered)
    tl = ServingLoop(tcfg, to_torch(jax.tree.map(np.asarray, params)), to_torch(tiered),
                     sizes=TierSizes(*jl.engine.sizes), device="cpu", **kw)
    assert tl.kv.sanitizer is not None and jl.kv.sanitizer is not None
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
    assert tl.stats.prefill_chunks == jl.stats.prefill_chunks
    assert tl.kv.stats.hit_rate == jl.kv.stats.hit_rate > 0


# ------------------------------------------------ paged-KV bookkeeping
def _mini_kv(n_slots=2, cache_len=16, block_size=4, **kw):
    cfg = tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH))
    return cfg, PagedKVCache(cfg, n_slots, cache_len, block_size=block_size,
                             device="cpu", **kw)


def test_radix_match_insert_and_lru_leaf_first_eviction():
    r = RadixPrefixIndex(2)
    assert r.insert([1, 2, 3, 4], [10, 11]) == [10, 11]
    assert r.insert([5, 6], [12]) == [12]
    assert r.insert([1, 2, 9, 9], [13, 14]) == [10, 14]
    assert r.match([1, 2, 3, 4, 7]) == [10, 11]
    assert r.match([1, 2, 3]) == [10]
    # leaf-first LRU: 12 is the least recently touched leaf; 10 has
    # children, so with 14 pinned the next victim is leaf 11
    assert r.evict_lru(lambda b: True) == 12
    assert r.evict_lru(lambda b: b != 14) == 11


def test_admit_commit_free_refcounts_and_reuse():
    cfg, kv = _mini_kv()
    assert kv.radix is not None and kv.sanitizer is not None
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 9).astype(np.int32)
    assert kv.admit_slot(0, prompt) == 0
    used = [b for b in kv.tables[0] if b != kv.trash]
    assert len(used) == 3 and all(kv.refcount[b] == 1 for b in used)
    kv.free_slot(0, tokens=prompt)
    assert kv.blocks_cached == 2  # full blocks stay radix-indexed
    assert kv.admit_slot(0, prompt) == 8
    kv.admit_slot(1, prompt)
    shared = kv.tables[0][:2].copy()
    assert list(kv.tables[1][:2]) == list(shared)
    assert all(kv.refcount[b] == 2 for b in shared)
    kv.free_slot(0)
    kv.free_slot(1)
    assert all(kv.refcount[b] == 0 for b in shared)


def test_commit_dedups_concurrent_duplicate_blocks():
    cfg, kv = _mini_kv()
    a = np.arange(9, dtype=np.int32)
    b = np.concatenate([np.arange(8), [99]]).astype(np.int32)
    kv.admit_slot(0, a)
    kv.admit_slot(1, b)
    dup = [int(x) for x in kv.tables[1][:2]]
    kv.commit_prompt(0, a)
    kv.commit_prompt(1, b)
    assert [int(x) for x in kv.tables[1][:2]] == [int(x) for x in kv.tables[0][:2]]
    assert all(kv.refcount[x] == 0 and x in kv._free for x in dup)
    assert kv.stats.dedup_blocks == 2


def test_copy_on_write_copies_the_pool_block():
    cfg, kv = _mini_kv()
    prompt = np.arange(8, dtype=np.int32)
    kv.admit_slot(0, prompt)
    kv.commit_prompt(0, prompt)
    kv.admit_slot(1, prompt)
    old = int(kv.tables[0][0])
    kv.pools["stack"]["slot0"]["k"][:, old] = 7.0
    new = kv.copy_on_write(0, 0)
    assert new != old and int(kv.tables[1][0]) == old
    assert kv.refcount[old] == 1 and kv.refcount[new] == 1
    assert torch.all(kv.pools["stack"]["slot0"]["k"][:, new] == 7.0)


def test_on_demand_alloc_eviction_and_exhaustion():
    cfg, kv = _mini_kv(n_slots=1, n_blocks=4)
    prompt = np.arange(5, dtype=np.int32)
    kv.admit_slot(0, prompt)
    kv.ensure_block(0, 8)  # crosses into logical block 2
    assert kv.blocks_in_use == 3
    kv.free_slot(0, tokens=prompt)
    kv.admit_slot(0, np.arange(100, 113, dtype=np.int32))
    assert kv.stats.evictions > 0  # radix blocks reclaimed LRU
    kv.free_slot(0)
    cfg, tiny = _mini_kv(n_slots=1, n_blocks=2)
    with pytest.raises(RuntimeError, match="exhausted"):
        tiny.admit_slot(0, np.arange(12, dtype=np.int32))


# --------------------------------------------------------- device rule
def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    cfg = tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.build_loop(cfg, batch=2, groups=1, cache_len=16)
    loop = tserve.build_loop(cfg, batch=2, groups=1, cache_len=16, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingLoop(cfg, loop.engine.params, loop.engine.tiered, batch_size=2)
    spec = ServingLoop(cfg, loop.engine.params, loop.engine.tiered, device="cpu",
                       spec_decode=True)
    assert spec.drafter is not None and spec.drafter.radix is spec.kv.radix
    assert next(iter(spec.kv.pools["stack"]["slot0"].values())).device.type == "cpu"
    slots = ServingLoop(cfg, loop.engine.params, loop.engine.tiered, device="cpu",
                        kv_layout="slots")
    assert slots.kv.cache["stack"]["slot0"]["k"].device.type == "cpu"


def test_serve_driver_runs_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--requests", "4", "--batch", "2",
                        "--groups", "1", "--new-tokens", "4", "--device", "cpu"]) == 16
    assert "4/4 requests" in capsys.readouterr().out


def test_serve_no_buckets_runs_exact_length_prefill(capsys):
    """`--no-buckets` maps to bucket_table=None, as in the reference's
    `launch/serve.py`: the loop still streams prompts in chunks, each
    chunk exactly as wide as its tokens."""
    assert tserve.main(["--arch", ARCH, "--smoke", "--requests", "4", "--batch", "2",
                        "--groups", "1", "--new-tokens", "4", "--device", "cpu",
                        "--no-buckets"]) == 16
    out = capsys.readouterr().out
    assert "4/4 requests" in out and "buckets=off" in out
