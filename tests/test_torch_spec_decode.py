"""Speculative decode of the PyTorch port against the JAX package: the
radix tree's read-only extension probe, the prompt-lookup drafter,
`PagedKVCache.truncate`, `decode_verify`, the engine's
`verify_slots_paged` and `ServingLoop(spec_decode=True)`.

Host bookkeeping (probe, drafts, tables, refcounts, free list) must be
equal. Logits are held at fp32 to 1e-5 (summation order only) and expert
counts exactly. The port's own chunk of 1 is bitwise its decode step,
and a chunk of k reproduces k sequential steps with equal greedy tokens,
as the reference's `tests/test_spec_decode.py` asserts for itself.
Serving: the spec loop's tokens equal the JAX spec loop's and the port's
plain loop's, for honest, corrupted and random drafts, with equal
counters. The KV sanitizer is on in every cache (tests/conftest.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models.model import decode_verify as jax_decode_verify
from repro.models.model import init_params as jax_init_params
from repro.serving.batching import Request as JaxRequest
from repro.serving.engine import fill_tiers_from_params as jax_fill_tiers
from repro.serving.engine import init_tiered_for_model as jax_init_tiered
from repro.serving.loop import ServingLoop as JaxServingLoop
from repro.serving.paged_kv import PagedKVCache as JaxPagedKVCache
from repro.serving.paged_kv import RadixPrefixIndex as JaxRadix
from repro.serving.paged_kv import init_paged_cache as jax_init_paged_cache
from repro.serving.spec_decode import DraftConfig as JaxDraftConfig
from repro.serving.spec_decode import PromptLookupDrafter as JaxDrafter
from repro_torch.bridge import to_torch
from repro_torch.models.model import decode_verify
from repro_torch.serving.batching import Request
from repro_torch.serving.kv_cache import batch_axis, tree_leaves
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.paged_kv import PagedKVCache, RadixPrefixIndex
from repro_torch.serving.spec_decode import DraftConfig, PromptLookupDrafter
from repro_torch.serving.tiered_moe import TierSizes

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
ATOL = RTOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


_SMOKE = {}


def _smoke(arch):
    """(JAX config, port config, host params) of an fp32 smoke config."""
    if arch not in _SMOKE:
        jcfg = _f32(reduce_for_smoke(get_config(arch)))
        tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(arch)))
        params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
        _SMOKE[arch] = jcfg, tcfg, params
    return _SMOKE[arch]


# ---------------------------------------------------- the radix probe
def _trees(seed):
    """The same random committed sequences inserted into both radix
    trees (block size 2, a small vocabulary so chains branch)."""
    rng = np.random.default_rng(seed)
    j, t = JaxRadix(2), RadixPrefixIndex(2)
    seqs = []
    bid = 0
    for _ in range(12):
        base = seqs[rng.integers(len(seqs))][: 2 * rng.integers(0, 4)] if seqs else []
        seq = list(base) + rng.integers(0, 4, size=2 * rng.integers(1, 5)).tolist()
        blocks = list(range(bid, bid + len(seq) // 2))
        bid += len(blocks)
        assert j.insert(seq, blocks) == t.insert(seq, blocks)
        seqs.append(seq)
    return rng, j, t, seqs


def _stamps(r):
    return r._clock, {b: n.stamp for b, n in r._nodes.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookup_extension_matches_and_is_read_only(seed):
    rng, j, t, seqs = _trees(seed)
    before_j, before_t = _stamps(j), _stamps(t)
    assert before_j == before_t
    probes = [s[:n] for s in seqs for n in range(len(s) + 1)]
    probes += [rng.integers(0, 4, size=rng.integers(0, 9)).tolist() for _ in range(40)]
    for hist in probes:
        for k in (0, 1, 3, 6):
            assert t.lookup_extension(hist, k) == j.lookup_extension(hist, k), (hist, k)
    assert _stamps(t) == before_t and _stamps(j) == before_j
    # eviction order is what it was before the probes
    assert t.evict_lru(lambda b: True) == j.evict_lru(lambda b: True)


@pytest.mark.parametrize("seed", [3, 4])
def test_drafter_matches_radix_first_then_ngrams(seed):
    rng, j, t, seqs = _trees(seed)
    cfg = dict(k=4, max_ngram=3, buffer_tokens=16)
    for radix in (False, True):
        jd = JaxDrafter(JaxDraftConfig(**cfg), radix=j if radix else None)
        td = PromptLookupDrafter(DraftConfig(**cfg), radix=t if radix else None)
        hists = [s[: rng.integers(1, len(s) + 1)] for s in seqs]
        hists += [rng.integers(0, 4, size=rng.integers(1, 24)).tolist() for _ in range(20)]
        for slot, hist in enumerate(hists):
            jd.begin_slot(slot, hist)
            td.begin_slot(slot, np.asarray(hist, np.int32))
            for k in (None, 0, 1, 2, 9):
                assert td.draft(slot, k) == jd.draft(slot, k), (radix, hist, k)
            tail = rng.integers(0, 4, size=3).tolist()
            jd.extend(slot, tail)
            td.extend(slot, tail)
            assert td.history(slot) == jd.history(slot)
            assert td.draft(slot) == jd.draft(slot)
            jd.free_slot(slot)
            td.free_slot(slot)
    assert _stamps(t) == _stamps(j)


# ----------------------------------------------------------- rollback
def _state(kv):
    return (kv.tables.tolist(), kv.refcount.tolist(), kv.lengths.tolist(), list(kv._free),
            list(kv._slot_free), kv.stats.cow_copies, sorted(kv.radix._nodes))


def test_truncate_matches_reference_bookkeeping():
    """The same admit / commit / ensure_block / truncate / free sequence
    on both caches leaves equal tables, refcounts, lengths and free
    lists: a dropped tail frees or decrefs; a kept partial tail block is
    copied on write when the radix indexes it or another slot shares it;
    a block-aligned cut copies nothing."""
    jcfg, tcfg, _ = _smoke("granite-moe-1b-a400m")
    j = JaxPagedKVCache(jcfg, 3, 24, block_size=4, sanitize=True)
    t = PagedKVCache(tcfg, 3, 24, block_size=4, sanitize=True, device="cpu")
    rng = np.random.default_rng(7)
    a = rng.integers(0, 100, 10).astype(np.int32)
    b = rng.integers(0, 100, 12).astype(np.int32)

    def both(fn, *args):
        getattr(j, fn)(*args)
        getattr(t, fn)(*args)
        assert _state(t) == _state(j), (fn, args)

    both("admit_slot", 0, a)
    both("commit_prompt", 0, a)
    for p in range(10, 16):
        both("ensure_block", 0, p)
    both("truncate", 0, 11)  # drops block 3; partial block 2 is private: no copy
    assert t.stats.cow_copies == 0
    both("admit_slot", 1, b)
    both("commit_prompt", 1, b)  # b's three full blocks enter the radix
    for p in range(12, 15):
        both("ensure_block", 1, p)
    src = int(t.tables[1, 1])
    leaf = t.pools["stack"]["slot0"]["k"]
    leaf[:, src] = 5.0
    both("truncate", 1, 6)  # partial block 1 is radix-indexed: copy on write
    assert t.stats.cow_copies == 1 and int(t.tables[1, 1]) != src
    assert torch.all(leaf[:, int(t.tables[1, 1])] == 5.0)
    both("admit_slot", 2, b)  # shares b's first two blocks with the radix
    shared = int(t.tables[2, 1])
    assert t.refcount[shared] >= 1 and shared in t.radix
    both("truncate", 2, 5)  # drops a fresh block; shared partial tail: copy
    assert t.stats.cow_copies == 2 and int(t.tables[2, 1]) != shared
    both("truncate", 0, 8)  # block-aligned: no copy
    assert t.stats.cow_copies == 2
    both("free_slot", 0, a)
    both("free_slot", 1)
    both("free_slot", 2)


# -------------------------------------------------------- the verify
def _verify_inputs(jcfg, seed, w=3, k=4, nb=6, bs=4):
    """Random pools, tables and chunks: row 0 k real tokens, row 1 one,
    the last row dead (length 0, all-trash table); pasts not aligned."""
    rng = np.random.default_rng(seed)
    n_blocks = w * nb + 2
    jpools, _ = jax_init_paged_cache(jcfg, w, n_blocks, bs)
    jpools = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jpools)
    tables = rng.permutation(n_blocks)[: w * nb].reshape(w, nb).astype(np.int32)
    tables[-1] = n_blocks
    lens = np.asarray([k, 1] + [0] * (w - 2), np.int32)
    past = np.asarray([9, 14] + [0] * (w - 2), np.int32)
    toks = rng.integers(0, jcfg.vocab_size, size=(w, k)).astype(np.int32)
    mask = np.arange(k)[None, :] < lens[:, None]
    return jpools, tables, past, toks, mask


def _tiered(arch, params):
    jcfg = _smoke(arch)[0]
    t = jax_fill_tiers(params, jax_init_tiered(jax.random.PRNGKey(1), jcfg, TierSizes(2, 2, 4)),
                       jcfg)
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_verify_matches_jax(arch):
    """Logits at every real chunk position to 1e-5, identical per-layer
    expert counts (one row per model layer, zeros for a dense one), and
    the chunk's K/V written where the reference writes it; the dead row
    and the pad positions write only the trash block."""
    jcfg, tcfg, params = _smoke(arch)
    tiered = _tiered(arch, params)
    jpools, tables, past, toks, mask = _verify_inputs(jcfg, 5)
    jl, jnew, _, jc = jax_decode_verify(
        params, jcfg, jnp.asarray(toks), jpools, jnp.asarray(tables), jnp.asarray(past),
        jnp.asarray(mask), tiered=tiered, cold_capacity_frac=1.0)
    tpools = to_torch(jpools)
    tl, tnew, tc = decode_verify(
        to_torch(params), tcfg, torch.tensor(toks), tpools, torch.tensor(tables),
        torch.tensor(past), torch.tensor(mask), tiered=to_torch(tiered),
        cold_capacity_frac=1.0)
    assert tnew is tpools and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.shape[0] == tcfg.n_layers and (tc.sum(-1) > 0).sum() == sum(
        tcfg.uses_moe_layer(i) for i in range(tcfg.n_layers))
    trash = int(tables[-1, 0])  # the dead row's all-trash table
    real = np.arange(trash)  # every block but the trash block
    untouched = sorted(set(range(trash)) - set(tables[:2].ravel().tolist()))
    for top in tnew:
        ax = batch_axis(top)
        for got, want, before in zip(tree_leaves(tnew[top]), jax.tree.leaves(jnew[top]),
                                     jax.tree.leaves(jpools[top])):
            got, want = got.numpy(), np.asarray(want)
            np.testing.assert_allclose(np.take(got, real, axis=ax),
                                       np.take(want, real, axis=ax), atol=ATOL, rtol=RTOL)
            # blocks no live row holds keep their contents
            np.testing.assert_array_equal(np.take(got, untouched, axis=ax),
                                          np.take(before, untouched, axis=ax))


def _loops(arch, **kw):
    """A JAX loop and a port loop on the same params and tier state."""
    jcfg, tcfg, params = _smoke(arch)
    jl = JaxServingLoop(jcfg, params, **kw)
    tl = ServingLoop(tcfg, to_torch(params), to_torch(jax.tree.map(np.asarray, jl.engine.tiered)),
                     sizes=TierSizes(*jl.engine.sizes), device="cpu", **kw)
    return jl, tl


def _prefill(loop, slot, prompt, argmax):
    past = loop.kv.admit_slot(slot, prompt)
    n = len(prompt) - past
    logits = loop.engine.prefill_slots_paged(prompt[None, past:], [slot],
                                             np.asarray([n], np.int32),
                                             np.asarray([past], np.int32))
    loop.kv.commit_prompt(slot, prompt)
    return argmax(logits[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_verify_matches_jax_and_dead_row_writes_trash(arch):
    """`verify_slots_paged` of a group with rows of 3, 1 and 2 chunk
    tokens (padded to width 4) and a dead row, on the same admitted
    slots: logits to 1e-5, identical counts, equal width sets, equal
    bookkeeping; the dead slot's length and blocks are untouched."""
    jl, tl = _loops(arch, batch_size=4, n_groups=1, cache_len=32)
    rng = np.random.default_rng(9)
    vocab = _smoke(arch)[1].vocab_size
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in (9, 14, 6, 11)]
    for s, p in enumerate(prompts):
        _prefill(jl, s, p, lambda x: int(jnp.argmax(x)))
        _prefill(tl, s, p, lambda x: int(torch.argmax(x)))
    lens = np.asarray([3, 1, 2, 0], np.int32)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    live = lens > 0
    chunks = np.zeros((4, 3), np.int32)
    for r in range(4):
        chunks[r, : lens[r]] = rng.integers(0, vocab, lens[r])
    for loop in (jl, tl):
        for r in np.nonzero(live)[0]:
            for p in range(pos[r], pos[r] + lens[r]):
                loop.kv.ensure_block(int(r), p)
    dead_blocks = tl.kv.tables[3][tl.kv.tables[3] != tl.kv.trash]
    pool = next(tree_leaves(tl.kv.pools["stack"]))
    dead_k = pool[:, dead_blocks].clone()
    jlog, jc = jl.engine.verify_slots_paged(chunks, [0, 1, 2, 3], lens, pos, live=live)
    tlog, tc = tl.engine.verify_slots_paged(chunks, [0, 1, 2, 3], lens, pos, live=live)
    real = np.arange(4)[None, :] < lens[:, None]
    assert tlog.shape == jlog.shape == (4, 4, vocab)
    np.testing.assert_allclose(tlog.numpy()[real], np.asarray(jlog)[real], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tl.engine.verify_widths == jl.engine.verify_widths == {4}
    assert tl.engine.verify_table_widths == jl.engine.verify_table_widths
    assert tl.engine.verify_compiles == len(jl.engine._verify_shapes) == 1
    assert tl.engine.stats.steps == jl.engine.stats.steps == 1
    assert _state(tl.kv) == _state(jl.kv)
    assert int(tl.kv.lengths[3]) == len(prompts[3])
    assert torch.equal(pool[:, dead_blocks], dead_k)


K_DRAFT = 4


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_chunk_matches_sequential_steps(arch):
    """One verify call over [t0, d1..dk-1] reproduces k sequential
    `step_slots_paged` calls of the port: a chunk of 1 is bitwise the
    decode step (logits and counts), and the chunk of k agrees to 1e-5
    with every step's logits and exactly in its greedy tokens."""
    _, tcfg, params = _smoke(arch)
    loop = ServingLoop(tcfg, to_torch(params), batch_size=2, n_groups=1, cache_len=24,
                       device="cpu")
    kv, eng = loop.kv, loop.engine
    prompt = np.random.default_rng(17).integers(0, tcfg.vocab_size, 10).astype(np.int32)
    plen = len(prompt)
    chain = [_prefill(loop, 0, prompt, lambda x: int(torch.argmax(x)))]
    seq_logits, seq_counts = [], []
    for j in range(K_DRAFT):
        kv.ensure_block(0, plen + j)
        lg, c = eng.step_slots_paged(np.asarray([[chain[-1]], [0]], np.int32),
                                     np.asarray([plen + j, 0], np.int32), [0, 1],
                                     kv.table_rows([0, 1]), live=np.asarray([True, False]))
        seq_logits.append(lg[0].clone())
        seq_counts.append(c.clone())
        chain.append(int(torch.argmax(lg[0])))
    kv.truncate(0, plen)
    kv.ensure_block(0, plen)
    one, c1 = eng.verify_slots_paged(np.asarray([[chain[0]], [0]], np.int32), [0, 1],
                                     np.asarray([1, 0], np.int32),
                                     np.asarray([plen, 0], np.int32),
                                     live=np.asarray([True, False]))
    assert torch.equal(one[0, 0], seq_logits[0]), "chunk of 1 is not bitwise the decode step"
    assert torch.equal(c1, seq_counts[0])
    kv.truncate(0, plen)
    for p in range(plen, plen + K_DRAFT):
        kv.ensure_block(0, p)
    ver, _ = eng.verify_slots_paged(np.asarray([chain[:K_DRAFT]], np.int32), [0],
                                    np.asarray([K_DRAFT], np.int32),
                                    np.asarray([plen], np.int32))
    for j in range(K_DRAFT):
        np.testing.assert_allclose(ver[0, j].numpy(), seq_logits[j].numpy(),
                                   atol=ATOL, rtol=RTOL)
        assert int(torch.argmax(ver[0, j])) == chain[j + 1]
    assert eng.verify_widths == {1, 4} and eng.verify_compiles == 2


# ------------------------------------------------------------ serving
def _serve(loop, prompts, new_tokens, rid0, req):
    for i, p in enumerate(prompts):
        loop.submit(req(rid=rid0 + i, prompt=np.asarray(p, np.int32),
                        max_new_tokens=new_tokens))
    done = loop.run(max_steps=500)
    return {r.rid - rid0: list(map(int, r.generated)) for r in done if r.rid >= rid0}


SPEC_COUNTERS = ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens", "decode_steps",
                 "generated_tokens", "replans", "migrations", "prefill_chunks")


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_serving_identical_to_jax_and_plain(arch):
    """Two waves of the same prompts (the second against a warm radix, so
    drafts land) plus a long prompt that chunk-prefills while other slots
    decode: the port's spec tokens equal the JAX spec loop's and the
    port's plain loop's, with equal counters, verify widths and hit
    rate, and accepted drafts."""
    _, tcfg, _ = _smoke(arch)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (9, 12, 31, 7)]
    kw = dict(batch_size=2, n_groups=1, cache_len=40, prefill_chunk_tokens=8)
    jl, tl = _loops(arch, spec_decode=True, **kw)
    _, plain = _loops(arch, **kw)
    want = _serve(plain, prompts, 6, 0, Request)
    for rid0 in (0, 100):
        assert _serve(tl, prompts, 6, rid0, Request) == want
        assert _serve(jl, prompts, 6, rid0, JaxRequest) == want
    st, jst = tl.stats, jl.stats
    assert st.spec_accepted_tokens > 0 and st.spec_drafted_tokens >= st.spec_accepted_tokens
    for name in SPEC_COUNTERS:
        assert getattr(st, name) == getattr(jst, name), name
    assert st.migrations > 0
    assert tl.engine.verify_widths == jl.engine.verify_widths
    assert len(tl.engine.verify_widths) > 1
    assert tl.engine.verify_compiles == jl.engine.verify_compiles
    assert tl.kv.stats.hit_rate == jl.kv.stats.hit_rate > 0
    snap = st.snapshot()
    assert snap["serving.spec_acceptance_rate"] == pytest.approx(
        st.spec_accepted_tokens / st.spec_drafted_tokens)
    assert st.spec_acceptance_rate == pytest.approx(jst.spec_acceptance_rate)
    assert "spec_acc=" in st.summary()


def test_spec_serving_with_whole_suffix_admission():
    """Spec decode behind whole-suffix admission (`chunked_prefill=False`,
    the first token sampled from each admission's own prefill): the same
    identities and counters, and no prefill chunk."""
    arch = "granite-moe-1b-a400m"
    _, tcfg, _ = _smoke(arch)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (9, 14, 6)]
    kw = dict(batch_size=2, n_groups=1, cache_len=32, chunked_prefill=False)
    jl, tl = _loops(arch, spec_decode=True, **kw)
    _, plain = _loops(arch, **kw)
    want = _serve(plain, prompts, 6, 0, Request)
    for rid0 in (0, 100):
        assert _serve(tl, prompts, 6, rid0, Request) == want
        assert _serve(jl, prompts, 6, rid0, JaxRequest) == want
    assert tl.stats.spec_accepted_tokens > 0 and tl.stats.prefill_chunks == 0
    for name in SPEC_COUNTERS:
        assert getattr(tl.stats, name) == getattr(jl.stats, name), name
    assert tl.engine.verify_widths == jl.engine.verify_widths


def _bad(draft, flips, vocab, hits=None):
    """`draft` with the tokens at positions `flips` changed; counts the
    drafts it changed in hits[0]."""
    def bad_draft(slot, k=None):
        out = list(draft(slot, k))
        for f in flips:
            if f < len(out):
                out[f] = (out[f] + 1 + f) % vocab
                if hits is not None:
                    hits[0] += 1
        return out
    return bad_draft


@pytest.mark.parametrize("flips", [(0,), (1,), (2,), (0, 2), (1, 3)])
def test_spec_identity_survives_corrupted_drafts(flips):
    """Draft tokens flipped at fixed positions in the warm wave: the
    verify / accept / rollback path still emits the plain greedy stream
    (as the reference's `test_spec_identity_survives_corrupted_drafts`),
    in both packages alike."""
    arch = "granite-moe-1b-a400m"
    _, tcfg, _ = _smoke(arch)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (10, 13)]
    kw = dict(batch_size=2, n_groups=1, cache_len=24)
    _, plain = _loops(arch, **kw)
    want = _serve(plain, prompts, 5, 0, Request)
    jl, tl = _loops(arch, spec_decode=True, **kw)
    assert _serve(tl, prompts, 5, 0, Request) == want
    _serve(jl, prompts, 5, 0, JaxRequest)
    hits = [0]
    tl.drafter.draft = _bad(tl.drafter.draft, flips, tcfg.vocab_size, hits)
    jl.drafter.draft = _bad(jl.drafter.draft, flips, tcfg.vocab_size)
    assert _serve(tl, prompts, 5, 100, Request) == want
    assert _serve(jl, prompts, 5, 100, JaxRequest) == want
    for name in SPEC_COUNTERS:
        assert getattr(tl.stats, name) == getattr(jl.stats, name), name
    # a changed draft is rejected at the change; the warm wave drafts at
    # most 2 tokens a step here, so a flip at 2 or later changes nothing
    assert (hits[0] > 0) == (min(flips) < 2)
    assert hits[0] == 0 or tl.stats.spec_drafted_tokens > tl.stats.spec_accepted_tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_identity_with_random_drafts(seed):
    """Seeded random draft lengths, corruption masks and prompt shapes (a
    long prompt that chunk-prefills mid-decode in some): the committed
    stream is the plain one (the cases of the reference's random-draft
    property test, drawn from a seed)."""
    _, tcfg, params = _smoke("granite-moe-1b-a400m")
    rng = np.random.default_rng(100 + seed)
    k = int(rng.integers(1, 6))
    flips = rng.integers(0, 5, size=int(rng.integers(0, 4))).tolist()
    lens = [8, 11] + ([29] if rng.random() < 0.5 or seed == 0 else [])
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in lens]
    kw = dict(batch_size=2, n_groups=1, cache_len=36, device="cpu")
    plain = ServingLoop(tcfg, to_torch(params), **kw)
    want = _serve(plain, prompts, 4, 0, Request)
    spec = ServingLoop(tcfg, to_torch(params), spec_decode=True,
                       spec_config=DraftConfig(k=k), **kw)
    assert _serve(spec, prompts, 4, 0, Request) == want
    spec.drafter.draft = _bad(spec.drafter.draft, flips, tcfg.vocab_size)
    assert _serve(spec, prompts, 4, 100, Request) == want


def test_spec_requires_paged_prefix_cacheable_arch():
    _, tcfg, params = _smoke("granite-moe-1b-a400m")
    with pytest.raises(AssertionError, match="spec_decode requires"):
        ServingLoop(tcfg, to_torch(params), batch_size=2, n_groups=1, cache_len=16,
                    kv_layout="slots", spec_decode=True, device="cpu")
