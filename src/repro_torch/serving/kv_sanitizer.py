"""Runtime sanitizer for the paged-KV block pool (repro-lint RL005's
dynamic twin).

The static rule can only prove that pool *writes* go through the
trash-routing helpers; whether the host-side bookkeeping that feeds
those writes (refcounts, block tables, free list, radix index) is
coherent is a runtime property. `PagedKVCache(sanitize=True)` attaches a
`KVSanitizer` that sweeps the full invariant set after every mutating
call and validates scatter targets at the engine boundary, raising a
structured `SanitizerError` at the first step that breaks an invariant —
instead of the silent cross-request K/V corruption these bugs actually
cause.

Checks:
  refcount_mismatch   refcount[b] != number of live block-table refs
  double_free         _decref on a refcount-0 block
  free_list           duplicate / referenced / radix-held / out-of-range
                      entry on the free list
  leak                refcount-0 block neither free nor radix-indexed
  radix               structural damage: node/block id disagreement,
                      unreachable node, LRU stamp ahead of the clock or
                      newer than its parent (breaks leaf-first eviction)
  slot_coherence      freed slot with a non-trash table row or nonzero
                      length; live slot whose committed length is not
                      covered by allocated blocks (or vice versa)
  shared_write        a write targeted at a refcount>1 block outside
                      copy-on-write (skipped/ broken COW)
  pad_write           a pad/dead row targeted at a real block instead of
                      the trash block
  unreferenced_write  a real row targeted at a block no slot references

Zero-cost when off: `PagedKVCache` holds `sanitizer=None` and every hook
is a single attribute test. Default resolves from $REPRO_KV_SANITIZE
(tests/conftest.py turns it on for the whole suite; serving_bench
--smoke forces it on).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

ENV_FLAG = "REPRO_KV_SANITIZE"


def sanitize_default() -> bool:
    """Resolve the ambient default for `PagedKVCache(sanitize=None)`."""
    return os.environ.get(ENV_FLAG, "").strip().lower() in (
        "1", "true", "on", "yes"
    )


class SanitizerError(RuntimeError):
    """One broken paged-KV invariant, machine-readable.

    kind:   one of the check names in the module docstring
    detail: human-oriented description with the offending values
    block / slot: the physical block id / slot index involved, when one
    is identifiable.
    """

    def __init__(self, kind: str, detail: str, *,
                 block: Optional[int] = None, slot: Optional[int] = None):
        self.kind = kind
        self.detail = detail
        self.block = block
        self.slot = slot
        loc = "".join(
            f" [{n}={v}]" for n, v in (("block", block), ("slot", slot))
            if v is not None
        )
        super().__init__(f"kv-sanitizer {kind}{loc}: {detail}")


class KVSanitizer:
    """Invariant sweeps + write-target checks over one `PagedKVCache`.

    Holds no state of its own beyond the cache reference — every check
    recomputes ground truth from the tables, so a sweep is trustworthy
    even after arbitrary external corruption (that is the point)."""

    def __init__(self, kv):
        self.kv = kv

    # ------------------------------------------------------ full sweep
    def validate(self, event: str = "check") -> None:
        """Sweep every host-side invariant; `event` names the mutating
        call just completed (it prefixes the failure detail)."""
        kv = self.kv
        n = kv.n_blocks

        def fail(kind, detail, **kw):
            raise SanitizerError(kind, f"after {event}: {detail}", **kw)

        # -- table sanity: every entry a real block id or the trash
        tbl = kv.tables
        bad = (tbl < 0) | (tbl > kv.trash)
        if bad.any():
            s, lb = np.argwhere(bad)[0]
            fail("slot_coherence",
                 f"table[{s},{lb}] = {tbl[s, lb]} is outside "
                 f"[0, {kv.trash}]", slot=int(s))

        # -- refcounts == live references from slot block tables
        refs = np.bincount(tbl[tbl != kv.trash].ravel(), minlength=n)
        if not np.array_equal(refs, kv.refcount):
            b = int(np.flatnonzero(refs != kv.refcount)[0])
            fail("refcount_mismatch",
                 f"block {b} has refcount {int(kv.refcount[b])} but "
                 f"{int(refs[b])} live table reference(s)", block=b)

        # -- free list: unique, in range, unreferenced, not radix-held
        free = kv._free
        if len(set(free)) != len(free):
            fail("free_list", "duplicate entries on the free list")
        for b in free:
            if not (0 <= b < n):
                fail("free_list", f"free-list id {b} out of range", block=b)
            if kv.refcount[b] != 0:
                fail("free_list",
                     f"block {b} is on the free list with refcount "
                     f"{int(kv.refcount[b])}", block=b)
            if kv.radix is not None and b in kv.radix:
                fail("free_list",
                     f"block {b} is both free and radix-indexed", block=b)

        # -- conservation: refcount-0 blocks are free or radix-cached
        idle = set(np.flatnonzero(kv.refcount == 0).tolist())
        idle -= set(free)
        if kv.radix is not None:
            idle -= set(kv.radix._nodes)
        if idle:
            b = min(idle)
            fail("leak",
                 f"block {b} has refcount 0 but is neither on the free "
                 f"list nor radix-indexed (unreclaimable)", block=b)

        # -- radix structure + LRU stamps
        if kv.radix is not None:
            self._validate_radix(fail)

        # -- slot coherence: freed slots empty; live lengths covered
        free_slots = kv._slot_free
        if len(set(free_slots)) != len(free_slots):
            fail("slot_coherence", "duplicate entries on the slot free list")
        bs = kv.block_size
        for s in range(kv.n_slots):
            row, length = tbl[s], int(kv.lengths[s])
            if s in free_slots:
                if length or (row != kv.trash).any():
                    fail("slot_coherence",
                         f"freed slot {s} still holds length={length}, "
                         f"blocks={row[row != kv.trash].tolist()}",
                         slot=s)
                continue
            if not 0 <= length <= kv.seq_len:
                fail("slot_coherence",
                     f"slot {s} length {length} outside [0, {kv.seq_len}]",
                     slot=s)
            nb = -(-length // bs)
            if (row[:nb] == kv.trash).any():
                lb = int(np.flatnonzero(row[:nb] == kv.trash)[0])
                fail("slot_coherence",
                     f"slot {s} committed {length} tokens but logical "
                     f"block {lb} is unallocated (trash)", slot=s)
            if (row[nb:] != kv.trash).any():
                lb = nb + int(np.flatnonzero(row[nb:] != kv.trash)[0])
                fail("slot_coherence",
                     f"slot {s} holds block {int(row[lb])} at logical "
                     f"block {lb} beyond its {length} committed tokens",
                     slot=s)

    def _validate_radix(self, fail) -> None:
        kv = self.kv
        radix = kv.radix
        for bid, node in radix._nodes.items():
            if node.block_id != bid:
                fail("radix",
                     f"index maps block {bid} to a node owning "
                     f"{node.block_id}", block=bid)
            if not 0 <= bid < kv.n_blocks:
                fail("radix", f"indexed block {bid} out of range",
                     block=bid)
            if node.parent is None or \
                    node.parent.children.get(node.key) is not node:
                fail("radix",
                     f"node for block {bid} detached from its parent "
                     f"(leaf-first eviction would never reach it)",
                     block=bid)
            if node.stamp > radix._clock:
                fail("radix",
                     f"block {bid} LRU stamp {node.stamp} is ahead of "
                     f"the clock {radix._clock}", block=bid)
            if node.parent is not radix.root and \
                    node.parent.stamp < node.stamp:
                fail("radix",
                     f"block {bid} (stamp {node.stamp}) looks newer than "
                     f"its parent block {node.parent.block_id} (stamp "
                     f"{node.parent.stamp}) — LRU would evict an inner "
                     f"block before its descendants", block=bid)
        # reachability: walking from the root must cover exactly _nodes
        seen = set()
        stack = [radix.root]
        while stack:
            for child in stack.pop().children.values():
                seen.add(child.block_id)
                stack.append(child)
        missing = set(radix._nodes) - seen
        extra = seen - set(radix._nodes)
        if missing or extra:
            b = min(missing or extra)
            fail("radix",
                 f"tree walk and _nodes disagree (unreachable="
                 f"{sorted(missing)}, unindexed={sorted(extra)})",
                 block=int(b))

    # ----------------------------------------------- write-target checks
    def check_writable(self, slot: int, pos: int) -> None:
        """Post-condition of `ensure_block`: the block about to take
        `slot`'s write at `pos` is private (exactly one reference) and
        real. A refcount>1 block here means copy-on-write was skipped —
        the write would leak into every other reader of that block."""
        kv = self.kv
        bid = int(kv.tables[slot, pos // kv.block_size])
        if bid == kv.trash:
            raise SanitizerError(
                "unreferenced_write",
                f"slot {slot} pos {pos} resolved to the trash block after "
                f"ensure_block — its token would be dropped", slot=slot)
        rc = int(kv.refcount[bid])
        if rc > 1:
            raise SanitizerError(
                "shared_write",
                f"slot {slot} pos {pos} targets block {bid} with refcount "
                f"{rc} — copy-on-write was skipped; the write would "
                f"corrupt {rc - 1} other reader(s)",
                block=bid, slot=slot)
        if rc < 1:
            raise SanitizerError(
                "unreferenced_write",
                f"slot {slot} pos {pos} targets block {bid} with refcount "
                f"0 — it may be reallocated mid-flight", block=bid,
                slot=slot)

    def check_scatter_targets(self, bids, mask) -> None:
        """Validate engine-assembled scatter targets before a device
        step. `bids` are the physical blocks each row's write lands in;
        `mask` marks real rows (False = pad / dead row). Pads must route
        to the trash block (RL005's contract, checked on the actual
        values); real rows must land in a private live block."""
        kv = self.kv
        bids = np.asarray(bids).ravel()
        mask = np.asarray(mask, bool).ravel()
        for b, real in zip(bids.tolist(), mask.tolist()):
            if not real:
                if b != kv.trash:
                    raise SanitizerError(
                        "pad_write",
                        f"pad/dead row routed to block {b} (refcount "
                        f"{int(kv.refcount[b]) if 0 <= b < kv.n_blocks else '?'}) "
                        f"instead of the trash block — garbage K/V would "
                        f"land in live state", block=int(b))
                continue
            if b == kv.trash:
                continue  # a live row may mask interior pads to trash
            rc = int(kv.refcount[b])
            if rc > 1:
                raise SanitizerError(
                    "shared_write",
                    f"live row writes block {b} with refcount {rc} "
                    f"outside copy-on-write", block=int(b))
            if rc < 1:
                raise SanitizerError(
                    "unreferenced_write",
                    f"live row writes block {b} with refcount 0",
                    block=int(b))
