"""Contiguous KV cache of the serving engine (port of
repro/serving/kv_cache.py: `cache_spec` :29, `cache_bytes` :34, `gather_slots` :47,
`scatter_slots` :56, `reset_slots` :70, `SlotKVCache` :90).

The model's contiguous cache (`models.model.init_cache`) holds, per slot,
a ring buffer of static length for every attention layer and the
recurrent state ({"state": {...}}, nested) of every Mamba / xLSTM layer.
Top-level keys are "layer<i>" (unrolled prefix layers; leaves carry the
slot dim on axis 0) and "stack" (scanned layers; leaves carry the
scan-group dim on axis 0 and the slot dim on axis 1). Every row-level operation here respects that
split. `gather_slots` copies rows out; `scatter_slots` and `reset_slots`
write in place (the JAX functions return new trees).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_cache


def cache_spec(cfg: ModelConfig, batch: int, seq: int):
    """The decode cache's tree on the meta device: every leaf's shape and
    dtype, nothing allocated (the reference's `eval_shape`, :29)."""
    return init_cache(cfg, batch, seq, device="meta")


def cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Bytes of a contiguous cache of `batch` rows of `seq` tokens: every
    leaf of `init_cache` at its own dtype (the reference counts its
    `eval_shape`). Attention layers hold ring buffers, recurrent layers
    their state (the SSM and xLSTM states fp32 under bf16 params)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(cache_spec(cfg, batch, seq)))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _index(slot_indices, device) -> torch.Tensor:
    return torch.as_tensor(slot_indices, dtype=torch.long).to(device)


def batch_axis(top_key: str) -> int:
    """Slot / pool leaves carry the scan-group dim first under "stack"."""
    return 1 if top_key == "stack" else 0


def tree_leaves(tree):
    """Tensor leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def gather_slots(cache, slot_indices):
    """The cache rows of `slot_indices` as a smaller-batch cache (a copy):
    the active zigzag group's view."""
    out = {}
    for k, v in cache.items():
        ax = batch_axis(k)
        out[k] = _map(v, lambda a, ax=ax: a.index_select(ax, _index(slot_indices, a.device)))
    return out


def _put(a: torch.Tensor, ax: int, idx: torch.Tensor, b) -> None:
    if ax == 0:
        a[idx] = b
    else:
        a[:, idx] = b


def scatter_slots(cache, sub_cache, slot_indices):
    """Write a gathered (or freshly prefilled) sub-batch cache into the
    full cache at `slot_indices`, in place. Inverse of gather_slots."""
    for k, v in cache.items():
        ax = batch_axis(k)
        for a, b in zip(tree_leaves(v), tree_leaves(sub_cache[k])):
            _put(a, ax, _index(slot_indices, a.device), b)
    return cache


def reset_slots(cache, slot_indices):
    """Zero the cache rows of recycled slots, in place: every leaf, the
    recurrent states' too (xLSTM's m then reads 0, not its init -inf, as
    in the reference; the next admission's prefill writes a fresh state)."""
    for k, v in cache.items():
        ax = batch_axis(k)
        for a in tree_leaves(v):
            _put(a, ax, _index(slot_indices, a.device), 0)
    return cache


def _infer_n_slots(cache) -> int:
    for k, v in cache.items():
        leaves = list(tree_leaves(v))
        if leaves:
            return int(leaves[0].shape[batch_axis(k)])
    raise ValueError("empty cache tree")


class SlotKVCache:
    """Slot-managed decode cache: a fixed pool of `n_slots` ring-buffer
    rows plus a free list, so the serving loop can admit a request into
    any free row and evict it (zeroing the row) on completion. Owns the
    cache tree; the engine reads and writes `.cache` through gather /
    scatter so only the active group's rows move."""

    def __init__(self, cfg: ModelConfig, n_slots: int, seq_len: int, device=None):
        self.cache = init_cache(cfg, n_slots, seq_len, device=device)
        self.n_slots = n_slots
        self.seq_len: Optional[int] = seq_len
        self._free: List[int] = list(range(n_slots))

    @classmethod
    def from_cache(cls, cache, seq_len: Optional[int] = None) -> "SlotKVCache":
        """Wrap an externally built cache tree. All slots start allocated:
        the caller composed the batch itself."""
        self = cls.__new__(cls)
        self.cache = cache
        self.n_slots = _infer_n_slots(cache)
        self.seq_len = seq_len
        self._free = []
        return self

    @property
    def n_free(self) -> int:
        return len(self._free)

    def allocate(self) -> Optional[int]:
        """Claim a free slot id, or None when the pool is exhausted."""
        return self._free.pop(0) if self._free else None

    def claim(self, slot: int) -> None:
        """Claim a specific free slot (the ZigzagBatcher picks it)."""
        assert slot in self._free, f"slot {slot} is not free"
        self._free.remove(slot)

    def free(self, slot_indices: Sequence[int]) -> None:
        """Evict finished requests: zero their rows and recycle the ids."""
        slots = [int(s) for s in slot_indices]
        if not slots:
            return
        taken = set(self._free)
        dup = [s for s in slots if s in taken or not 0 <= s < self.n_slots]
        assert not dup, f"double free / out of range: {dup}"
        assert len(set(slots)) == len(slots), f"duplicate slots in free: {slots}"
        reset_slots(self.cache, slots)
        self._free.extend(slots)

    def gather(self, slot_indices):
        return gather_slots(self.cache, slot_indices)

    def scatter(self, sub_cache, slot_indices) -> None:
        scatter_slots(self.cache, sub_cache, slot_indices)
