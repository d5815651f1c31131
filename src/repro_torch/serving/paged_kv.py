"""Paged KV cache with radix prefix reuse (port of repro/serving/paged_kv.py:
`prefix_cacheable` :45, `init_paged_cache` :61, `RadixPrefixIndex` :113
with `lookup_extension` :161, `PagedKVCache` :260 with `truncate` :524).
The host bookkeeping (tables, refcounts, free list, radix index) is the
reference's, attribute names included, so serving/kv_sanitizer.py sweeps
it unchanged; the pools are torch tensors on the serving device.

A contiguous cache reserves one contiguous max-seq strip per slot, so memory
is committed at admission for tokens that may never be generated and
identical prompt prefixes (system prompts, few-shot headers) are stored
— and recomputed — once per request. This module replaces that with a
vLLM/SGLang-style paged layout:

  * K/V (and MLA latent) cache entries live in a shared POOL of
    fixed-size token blocks ([n_blocks + 1, block_size, ...]; the last
    block is a write trash for dead decode rows);
  * each slot holds a BLOCK TABLE mapping logical block index ->
    physical block id; blocks are allocated on demand as decode crosses
    block boundaries;
  * blocks are REFCOUNTED: a radix tree keyed on token ids indexes full
    (immutable) blocks so a new request claims its longest cached
    prefix without recompute, refcount-0 radix blocks are reclaimed LRU
    when the pool runs dry, and copy-on-write protects a shared block
    if a writer ever diverges into it;
  * recurrent state (Mamba / xLSTM) has no sequence dim: it stays
    per slot in `slot_state`, and prefix reuse is gated off for archs
    that carry it (a token-keyed prefix cannot rebuild a recurrent
    state): `radix` is then None.

Why it matters here: the TriMoE setting is HBM-budget-driven (paper
§3.1) — every KV byte the pool does NOT commit relative to the
contiguous layout is handed to `tiered_moe.tier_sizes` as
`reclaimed_kv_bytes`, buying more HBM-resident hot experts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import (
    MIXERS,
    check_decoder_only,
    init_states,
    is_recurrent,
    layer_tree,
)
from repro_torch.serving.kv_cache import batch_axis, cache_bytes, tree_leaves
from repro_torch.serving.kv_sanitizer import KVSanitizer, SanitizerError, sanitize_default


def prefix_cacheable(cfg: ModelConfig) -> bool:
    """Prefix reuse (and chunked prefill) needs every mixer's cache to be
    token-position addressable: attention K/V and MLA latents qualify;
    recurrent state and enc-dec cross K/V do not (reference :45)."""
    return cfg.encdec is None and not is_recurrent(cfg)


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_blocks: int, block_size: int,
                     device=None):
    """(pools, slot_state) of the paged layout (reference :61). pools: one
    set per attention layer, [n_blocks + 1, block_size, ...] per leaf of
    the mixer's `cache_shapes` (stack leaves: [G, n_blocks + 1, ...]); the
    last block is the write trash. slot_state: every recurrent layer's
    state, one row per slot, at its real init values (xLSTM's m at -inf),
    in the same "layer<i>" / "stack" layout, so the slot gather / scatter
    helpers apply to it unchanged."""
    check_decoder_only(cfg, "the paged layout")
    dt = torch_dtype(cfg.param_dtype)

    def pools_of(sig, lead):
        shapes = MIXERS[sig[0]].cache_shapes
        return {} if shapes is None else {
            k: torch.zeros((*lead, n_blocks + 1, block_size, *shape[1:]), dtype=dt,
                           device=device)
            for k, shape in shapes(cfg, block_size).items()}

    return layer_tree(cfg, pools_of), init_states(cfg, n_slots, device)


# --------------------------------------------------------- radix index
class _RadixNode:
    __slots__ = ("children", "parent", "key", "block_id", "stamp")

    def __init__(self, parent, key, block_id, stamp):
        self.children: Dict[Tuple[int, ...], _RadixNode] = {}
        self.parent = parent
        self.key = key  # the full-block token tuple edge from parent
        self.block_id = block_id  # None only at the root
        self.stamp = stamp


class RadixPrefixIndex:
    """Radix tree over FULL blocks of token ids.

    Each edge is one block's worth of token ids; each node owns the
    physical block holding that chunk's K/V. Only full blocks are
    indexed — they are immutable by construction (decode appends past
    them), so shared reads can never race a write. Matching walks the
    prompt block-by-block; insertion adopts the caller's blocks for
    chunks the tree does not yet hold. Touch stamps power LRU eviction
    (leaf-first: an inner block can only be reclaimed after its
    descendants, preserving prefix contiguity)."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _RadixNode(None, None, None, 0)
        self._clock = 0
        self._nodes: Dict[int, _RadixNode] = {}  # block_id -> node

    def __len__(self) -> int:
        return len(self._nodes)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens) -> List[Tuple[int, ...]]:
        bs = self.block_size
        toks = [int(t) for t in tokens]
        return [
            tuple(toks[i: i + bs]) for i in range(0, len(toks) - bs + 1, bs)
        ]

    def match(self, tokens) -> List[int]:
        """Block ids of the longest indexed prefix of full blocks."""
        node, out, stamp = self.root, [], self._tick()
        for chunk in self._chunks(tokens):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            nxt.stamp = stamp
            out.append(nxt.block_id)
            node = nxt
        # bump ancestors too, so inner nodes never look older than leaves
        while node is not self.root:
            node.stamp = max(node.stamp, stamp)
            node = node.parent
        return out

    def lookup_extension(self, tokens, k: int) -> List[int]:
        """Speculative-draft probe: up to `k` token ids the tree has
        seen FOLLOWING `tokens`. Walks the full-block chunks of the
        history, consumes a partial-block remainder against a matching
        child edge, then descends deterministically (lexicographically
        smallest edge) gathering tokens.

        READ-ONLY by contract: no `_tick`, no stamp updates — a
        speculative probe must not look like a cache hit to LRU
        eviction, or drafting would pin blocks it never claims."""
        if k <= 0:
            return []
        bs = self.block_size
        toks = [int(t) for t in tokens]
        node = self.root
        for ci in range(len(toks) // bs):
            node = node.children.get(tuple(toks[ci * bs:(ci + 1) * bs]))
            if node is None:
                return []
        out: List[int] = []
        rem = tuple(toks[(len(toks) // bs) * bs:])
        if rem:
            for key in sorted(node.children):
                if key[: len(rem)] == rem:
                    out.extend(key[len(rem):])
                    node = node.children[key]
                    break
            else:
                return []
        while len(out) < k and node.children:
            key = min(node.children)
            out.extend(key)
            node = node.children[key]
        return [int(t) for t in out[:k]]

    def insert(self, tokens, block_ids: Sequence[int]) -> List[int]:
        """Index `tokens`' full blocks, adopting the caller's physical
        blocks for chunks not yet present. Returns the CANONICAL block
        id per chunk: the caller's block where it was adopted, the
        tree's original block where the chunk was already indexed
        (chunk content — the token tuple hashed by the child dict — is
        the dedup key; a path match implies the whole prefix matches).
        A caller holding a different block than the returned canonical
        one computed a concurrent duplicate and should repoint to the
        canonical block and release its copy
        (PagedKVCache.commit_prompt)."""
        node, canonical, stamp = self.root, [], self._tick()
        for chunk, bid in zip(self._chunks(tokens), block_ids):
            nxt = node.children.get(chunk)
            if nxt is None:
                nxt = _RadixNode(node, chunk, int(bid), stamp)
                node.children[chunk] = nxt
                self._nodes[int(bid)] = nxt
            else:
                nxt.stamp = stamp
            canonical.append(nxt.block_id)
            node = nxt
        return canonical

    def __contains__(self, block_id: int) -> bool:
        return int(block_id) in self._nodes

    def evict_lru(self, evictable) -> Optional[int]:
        """Remove and return the least-recently-touched LEAF whose block
        satisfies `evictable(block_id)` (refcount 0), or None."""
        best = None
        for bid, node in self._nodes.items():
            if node.children or not evictable(bid):
                continue
            if best is None or node.stamp < best.stamp:
                best = node
        if best is None:
            return None
        del best.parent.children[best.key]
        del self._nodes[best.block_id]
        return best.block_id


# ------------------------------------------------------------ the cache
@dataclasses.dataclass
class PagedStats:
    lookups: int = 0
    lookup_tokens: int = 0
    hits: int = 0  # admissions with at least one cached block
    hit_tokens: int = 0  # prompt tokens served from cache, no recompute
    evictions: int = 0
    cow_copies: int = 0
    dedup_blocks: int = 0  # duplicate blocks reclaimed at commit time
    peak_blocks_in_use: int = 0  # high-water mark of live references

    @property
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from cache;
        exactly 0.0 before any traffic (no division by zero)."""
        if self.lookup_tokens <= 0:
            return 0.0
        return self.hit_tokens / self.lookup_tokens


class PagedKVCache:
    """Block-pool KV cache with per-slot block tables and radix prefix
    reuse. Owns the device pools + per-slot state pytrees and all host
    bookkeeping (tables, refcounts, free list, radix index).

    Lifecycle per request:
      admit_slot(slot, prompt)  -> prefix match claims cached blocks
                                   (refcount++), fresh blocks cover the
                                   uncached prompt suffix; returns the
                                   cached prefix length
      commit_prompt(slot, ...)  -> after the suffix prefill lands, the
                                   prompt's full blocks are indexed in
                                   the radix tree for future sharing
      ensure_block(slot, pos)   -> decode allocates blocks on demand at
                                   block boundaries, copy-on-write if
                                   the target is shared
      free_slot(slot, tokens)   -> full blocks (prompt + generated) are
                                   indexed, refcounts drop; refcount-0
                                   radix blocks stay reclaimable (LRU),
                                   the rest return to the free list
    """

    def __init__(
        self,
        cfg: ModelConfig,
        n_slots: int,
        cache_len: int,
        *,
        block_size: int = 4,
        n_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        sanitize: Optional[bool] = None,
        device=None,
    ):
        assert cfg.encdec is None, "paged KV does not support enc-dec"
        bs = block_size
        self.cfg = cfg
        self.block_size = bs
        self.n_slots = n_slots
        self.blocks_per_slot = -(-cache_len // bs)
        self.seq_len = self.blocks_per_slot * bs  # per-slot capacity
        self.n_blocks = (
            n_blocks if n_blocks is not None
            else n_slots * self.blocks_per_slot
        )
        self.pools, self.slot_state = init_paged_cache(cfg, n_slots, self.n_blocks, bs,
                                                       device)
        self.trash = self.n_blocks  # sentinel physical block id
        self.tables = np.full(
            (n_slots, self.blocks_per_slot), self.trash, np.int32
        )
        self.lengths = np.zeros((n_slots,), np.int64)  # committed tokens
        self.refcount = np.zeros((self.n_blocks,), np.int32)
        self._free: List[int] = list(range(self.n_blocks))
        self._slot_free: List[int] = list(range(n_slots))
        self.radix = (
            RadixPrefixIndex(bs) if prefix_cache and prefix_cacheable(cfg) else None
        )
        self.stats = PagedStats()
        # None = resolve from $REPRO_KV_SANITIZE (tests turn it on suite-
        # wide). Off-mode cost is one attribute test per mutating call.
        if sanitize is None:
            sanitize = sanitize_default()
        self.sanitizer: Optional[KVSanitizer] = (
            KVSanitizer(self) if sanitize else None
        )

    # ------------------------------------------------------- accounting
    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by at least one live slot."""
        return int((self.refcount > 0).sum())

    @property
    def blocks_cached(self) -> int:
        """Refcount-0 blocks kept alive by the radix index (reclaimable)."""
        return 0 if self.radix is None else sum(
            1 for b in self.radix._nodes if self.refcount[b] == 0
        )

    def paged_bytes(self) -> int:
        """Bytes of the pools and the per-slot recurrent state, each leaf
        at its own dtype (reference :353)."""
        return sum(leaf.numel() * leaf.element_size()
                   for tree in (self.pools, self.slot_state) for leaf in tree_leaves(tree))

    def reclaimed_bytes(self, cache_len: int) -> int:
        """HBM the paged layout hands back vs the contiguous SlotKVCache
        at the same slot count — the budget `tier_sizes` converts into
        extra hot-resident experts. Never negative (a pool LARGER than
        the contiguous reservation reclaims nothing), and exactly 0 for
        a zero/negative `cache_len` (there is no contiguous layout to
        compare against)."""
        if cache_len <= 0:
            return 0
        return max(
            0, cache_bytes(self.cfg, self.n_slots, cache_len) - self.paged_bytes()
        )

    # ------------------------------------------------------- allocation
    def _alloc_block(self) -> int:
        if self._free:
            return self._free.pop()
        if self.radix is not None:
            bid = self.radix.evict_lru(lambda b: self.refcount[b] == 0)
            if bid is not None:
                self.stats.evictions += 1
                return bid
        raise RuntimeError(
            "paged KV pool exhausted: all blocks are referenced by live "
            "slots; grow n_blocks or admit fewer concurrent requests"
        )

    def _decref(self, bid: int) -> None:
        if self.refcount[bid] <= 0:
            raise SanitizerError(
                "double_free",
                f"releasing block {bid} with refcount "
                f"{int(self.refcount[bid])}", block=int(bid),
            )
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0 and (
            self.radix is None or bid not in self.radix
        ):
            self._free.append(bid)

    # ------------------------------------------------- slot management
    def claim(self, slot: int) -> None:
        assert slot in self._slot_free, f"slot {slot} is not free"
        self._slot_free.remove(slot)

    def admit_slot(self, slot: int, prompt) -> int:
        """Claim `slot`, reuse the longest cached prefix, and allocate
        fresh blocks covering the uncached rest of the prompt. Returns
        the cached prefix length (the prefill may skip that many
        tokens)."""
        self.claim(slot)
        plen = len(prompt)
        assert plen <= self.seq_len, (slot, plen, self.seq_len)
        past = 0
        row = self.tables[slot]
        self.stats.lookups += 1
        self.stats.lookup_tokens += plen
        if self.radix is not None and plen > 1:
            blocks = self.radix.match(prompt)
            # never negative: a 0/1-token prompt has no reusable prefix
            usable = ((plen - 1) // self.block_size) * self.block_size
            past = min(len(blocks) * self.block_size, usable)
            for lb in range(past // self.block_size):
                row[lb] = blocks[lb]
                self.refcount[blocks[lb]] += 1
            if past:
                self.stats.hits += 1
                self.stats.hit_tokens += past
        for lb in range(past // self.block_size, -(-plen // self.block_size)):
            row[lb] = self._alloc_block()
            self.refcount[row[lb]] += 1
        self.lengths[slot] = plen
        self.stats.peak_blocks_in_use = max(
            self.stats.peak_blocks_in_use, self.blocks_in_use
        )
        if self.sanitizer is not None:
            self.sanitizer.validate("admit_slot")
        return past

    def commit_prompt(self, slot: int, prompt) -> None:
        """Index the prompt's full blocks after their K/V has been
        computed, so concurrent and future admissions can share them.

        Content dedup: when another slot committed the same chunk first
        (two requests with a shared uncached prefix admitted in the
        same wave each compute their own copy), `insert` returns the
        tree's canonical block — this slot is repointed to it and its
        duplicate is reclaimed IMMEDIATELY instead of idling until the
        slot frees. Only full committed blocks are ever repointed
        (decode appends past them), so no writer can race the swap."""
        if self.radix is None:
            return
        n_full = len(prompt) // self.block_size
        mine = [int(b) for b in self.tables[slot][:n_full]]
        canonical = self.radix.insert(prompt, mine)
        for lb, (dup, canon) in enumerate(zip(mine, canonical)):
            if canon == dup:
                continue
            if self.refcount[dup] != 1:
                # defensive: a shared-but-uncanonical block can only be
                # radix-sourced, which implies canon == dup — skip
                continue
            self.tables[slot, lb] = canon
            self.refcount[canon] += 1
            self._decref(dup)
            self.stats.dedup_blocks += 1
        if self.sanitizer is not None:
            self.sanitizer.validate("commit_prompt")

    def ensure_block(self, slot: int, pos: int) -> None:
        """Decode-time: make position `pos` writable for `slot` —
        allocate the logical block on demand and copy-on-write if the
        resident block is shared."""
        lb = pos // self.block_size
        assert lb < self.blocks_per_slot, (slot, pos, self.seq_len)
        bid = self.tables[slot, lb]
        if bid == self.trash:
            nb = self._alloc_block()
            self.tables[slot, lb] = nb
            self.refcount[nb] += 1
            self.stats.peak_blocks_in_use = max(
                self.stats.peak_blocks_in_use, self.blocks_in_use
            )
        elif self.refcount[bid] > 1:
            self.copy_on_write(slot, lb)
        self.lengths[slot] = max(self.lengths[slot], pos + 1)
        if self.sanitizer is not None:
            # post-condition first: a skipped COW is caught here even
            # when the global bookkeeping still sweeps clean
            self.sanitizer.check_writable(slot, pos)
            self.sanitizer.validate("ensure_block")

    def copy_on_write(self, slot: int, logical_block: int) -> int:
        """Divergence into a shared block: give `slot` a private copy of
        the physical block so its writes never reach other readers."""
        old = int(self.tables[slot, logical_block])
        new = self._alloc_block()

        for top, sub in self.pools.items():
            for leaf in tree_leaves(sub):  # in place: block `new` := block `old`
                if batch_axis(top) == 0:
                    leaf[new] = leaf[old]
                else:
                    leaf[:, new] = leaf[:, old]
        self.refcount[new] += 1
        self._decref(old)
        self.tables[slot, logical_block] = new
        self.stats.cow_copies += 1
        if self.sanitizer is not None:
            self.sanitizer.validate("copy_on_write")
        return new

    def truncate(self, slot: int, n: int) -> None:
        """Speculative-decode rollback: shrink `slot` to `n` committed
        tokens, releasing the rejected tail's block references.

        Dropped tail blocks are `_decref`'d — a block physically frees
        only when this slot held the LAST reference (rc==1) and the
        radix does not index it; shared or cached blocks just lose one
        reference. A kept PARTIAL tail block is detached when shared
        (rc>1) or radix-indexed via copy-on-write: future decode writes
        land at positions >= n inside it, and neither another reader
        nor the index's immutable full-content chunk may see them."""
        assert slot not in self._slot_free, f"slot {slot} is free"
        length = int(self.lengths[slot])
        assert 0 <= n <= length, (slot, n, length)
        bs = self.block_size
        new_nb = -(-n // bs)
        # lengths first: copy_on_write/validate below sweep
        # slot_coherence against ceil(length/bs)
        self.lengths[slot] = n
        for lb in range(new_nb, -(-length // bs)):
            bid = int(self.tables[slot, lb])
            if bid != self.trash:
                self._decref(bid)
            self.tables[slot, lb] = self.trash
        if n % bs:
            bid = int(self.tables[slot, new_nb - 1])
            if self.refcount[bid] > 1 or (
                self.radix is not None and bid in self.radix
            ):
                self.copy_on_write(slot, new_nb - 1)
        if self.sanitizer is not None:
            self.sanitizer.validate("truncate")

    def free_slot(self, slot: int, tokens=None) -> None:
        """Evict a finished request: index its full blocks (prompt +
        generated tokens, when given) for future prefix hits, then drop
        the slot's references."""
        if tokens is not None:
            self.commit_prompt(slot, tokens)
        for lb in range(self.blocks_per_slot):
            bid = int(self.tables[slot, lb])
            if bid != self.trash:
                self._decref(bid)
            self.tables[slot, lb] = self.trash
        self.lengths[slot] = 0
        self._slot_free.append(slot)
        if self.sanitizer is not None:
            self.sanitizer.validate("free_slot")

    # ---------------------------------------------------------- views
    def table_rows(self, slot_indices) -> np.ndarray:
        return self.tables[np.asarray(slot_indices, np.int64)]
