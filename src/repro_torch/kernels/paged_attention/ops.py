"""Width bucketing for paged attention (port of
repro/kernels/paged_attention/ops.py:50-72).

`active_block_width` is the single pow2 width-bucketing rule both
serving phases slice block tables with: decode buckets by the longest
live row, chunked prefill by the furthest row end (prefix + suffix), so
either path's attention reads O(active blocks), not O(blocks_per_slot).
"""
from __future__ import annotations


def active_block_width(max_pos: int, block_size: int, max_blocks: int) -> int:
    """Block-table columns a paged-attention call needs for rows ending
    at `max_pos`: ceil((max_pos + 1) / block_size), rounded up to a power
    of two, capped at the full table width."""
    need = max(1, (int(max_pos) + block_size) // block_size)
    width = 1
    while width < need:
        width *= 2
    return min(width, max_blocks)


def n_width_buckets(max_blocks: int) -> int:
    """How many distinct widths `active_block_width` can return for a
    table of `max_blocks` columns (the pow2 ladder plus the cap)."""
    n, width = 1, 1
    while width < max_blocks:
        width *= 2
        n += 1
    return n
