"""Prompt-lookup speculative drafting for the serving loop (a copy of
repro/serving/spec_decode.py; numpy-free host code, no RNG).

MoBiLE's cheap-replica philosophy (PAPERS.md) applied to decode: serve
drafts from what is ALREADY resident instead of running a second model.
Two free sources of likely continuations exist in this codebase:

  * the per-slot token history (prompt + everything generated so far) —
    repetitive outputs (code, JSON, agentic traces) repeat their own
    n-grams, so the longest history suffix that occurred earlier
    predicts what followed it (prompt-lookup / n-gram decoding);
  * the radix prefix index, which stores full token-id blocks of every
    COMMITTED sequence — on replayed or templated traffic the exact
    continuation of the current history is sitting in the tree
    (`RadixPrefixIndex.lookup_extension`, a read-only probe that never
    touches LRU stamps).

The drafter is fully deterministic (no RNG — replay determinism is a
repo invariant, enforced by repro-lint RL007) and drafts are CHEAP to
be wrong about: verification through the chunk-of-k kernel path
(engine.verify_slots_paged) corrects any mismatch, so a bad draft costs
only wasted verify columns, never correctness.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.paged_kv import RadixPrefixIndex


@dataclasses.dataclass(frozen=True)
class DraftConfig:
    """Drafter knobs (README "Speculative decode").

    k: max draft tokens proposed per decode step (the verify chunk is
       1 + k wide before pow2 padding);
    max_ngram/min_ngram: suffix n-gram lengths tried, longest first,
       against the slot's own history;
    buffer_tokens: how much recent history the n-gram scan looks at
       (the radix probe always uses the full history — the tree is
       keyed on absolute prefixes).
    """

    k: int = 4
    max_ngram: int = 8
    min_ngram: int = 1
    buffer_tokens: int = 512


class PromptLookupDrafter:
    """Longest-suffix-match drafter over per-slot token buffers.

    The loop owns the lifecycle: `begin_slot` at admission (seeds the
    buffer with the prompt), `extend` on every committed token (first
    prefill token, plain decode samples, accepted spec commits),
    `free_slot` on eviction. `draft` proposes up to k tokens by trying
    the slot's own history first (longest n-gram suffix that recurred,
    latest occurrence wins) and the radix prefix index second.
    """

    def __init__(
        self,
        cfg: Optional[DraftConfig] = None,
        radix: Optional[RadixPrefixIndex] = None,
    ):
        self.cfg = cfg or DraftConfig()
        self.radix = radix
        self._hist: Dict[int, List[int]] = {}

    # ---------------------------------------------------- slot lifecycle
    def begin_slot(self, slot: int, prompt) -> None:
        self._hist[slot] = [int(t) for t in prompt]

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        self._hist[slot].extend(int(t) for t in tokens)

    def free_slot(self, slot: int) -> None:
        self._hist.pop(slot, None)

    def history(self, slot: int) -> List[int]:
        return list(self._hist[slot])

    # ----------------------------------------------------------- drafting
    def _ngram_draft(self, hist: List[int], k: int) -> List[int]:
        """Longest suffix n-gram that occurred EARLIER in the history:
        propose the tokens that followed its latest occurrence."""
        cfg = self.cfg
        window = hist[-cfg.buffer_tokens:]
        n_max = min(cfg.max_ngram, len(window) - 1)
        for n in range(n_max, cfg.min_ngram - 1, -1):
            suffix = window[-n:]
            # latest earlier occurrence; the match must be followed by
            # at least one token that is not part of the suffix itself
            for i in range(len(window) - n - 1, -1, -1):
                if window[i:i + n] == suffix:
                    out = window[i + n:i + n + k]
                    if out:
                        return out
        return []

    def draft(self, slot: int, k: Optional[int] = None) -> List[int]:
        """Up to k draft tokens for `slot`, [] when neither source has
        a match (the step then verifies a plain chunk of 1).

        The radix probe goes first: an indexed extension of the FULL
        history (a previously committed identical sequence) is strictly
        stronger evidence than a local n-gram recurrence, which is the
        fallback for histories the tree has never seen."""
        k = self.cfg.k if k is None else min(k, self.cfg.k)
        if k <= 0:
            return []
        hist = self._hist[slot]
        out: List[int] = []
        if self.radix is not None:
            out = self.radix.lookup_extension(hist, k)
        if not out:
            out = self._ngram_draft(hist, k)
        return out[:k]
