"""Request batching for high-throughput offloading serving (paper §2.2).

Offloading systems amortize weight movement over LARGE effective batches:
offline batching concatenates queued requests; zigzag batching (paper's
[9]) interleaves several micro-batches so that while one waits on
off-GPU experts another decodes. Here we implement the batch-composition
logic (the part above the step function): a request queue, slot
allocation into a fixed decode batch, and zigzag group rotation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class BucketTable:
    """Prompt-length buckets for padded prefill.

    Admission pads every prompt up to the smallest bucket width >= its
    length, so the jitted prefill only ever sees len(widths) distinct
    shapes — the compile-count bound the CI gate asserts
    (benchmarks/serving_bench.py --mixed).
    """

    widths: Tuple[int, ...]

    def __post_init__(self):
        assert self.widths, "bucket table needs at least one width"
        assert all(w > 0 for w in self.widths)
        assert list(self.widths) == sorted(set(self.widths)), (
            f"bucket widths must be strictly ascending: {self.widths}"
        )

    def __len__(self) -> int:
        return len(self.widths)

    def bucket_of(self, length: int) -> int:
        """Smallest bucket width that fits `length`."""
        for w in self.widths:
            if length <= w:
                return w
        raise ValueError(
            f"prompt length {length} exceeds the largest bucket "
            f"({self.widths[-1]}); widen the table or the cache"
        )

    @classmethod
    def powers_of_two(cls, max_width: int, min_width: int = 8) -> "BucketTable":
        """Powers of two from min_width up, capped by (and always
        including) max_width — e.g. max 24 -> (8, 16, 24)."""
        assert max_width >= 1
        widths: List[int] = []
        w = min_width
        while w < max_width:
            widths.append(w)
            w *= 2
        widths.append(max_width)
        return cls(tuple(widths))


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32 [prompt_len]
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclass
class BatchSlot:
    request: Optional[Request] = None
    pos: int = 0  # absolute decode position
    # chunked piggyback prefill (ServingLoop): the request is admitted
    # but its prompt is still streaming into the cache chunk-by-chunk —
    # the slot must sit OUT of decode groups until the prefill lands
    prefilling: bool = False


class ZigzagBatcher:
    """Fixed-width decode batch with zigzag group rotation.

    `n_groups` micro-batches share the device; group g is active on steps
    where step % n_groups == g, letting expert fetch for one group overlap
    another group's compute (the paper's high-throughput setting).

    With a `bucket_table`, admission is BUCKET-AWARE: queued requests
    whose prompt lengths fall in the same bucket are admitted together
    (FIFO within the head-of-queue's bucket) so the loop can batch them
    into one padded prefill call. A partial cohort is held back for more
    same-bucket arrivals, but never past `max_admit_wait` admit calls —
    the starvation cap for lone long prompts (test_batching.py).
    """

    def __init__(self, batch_size: int, n_groups: int = 2,
                 bucket_table: Optional[BucketTable] = None,
                 max_admit_wait: int = 4):
        assert batch_size % n_groups == 0
        self.batch_size = batch_size
        self.n_groups = n_groups
        self.bucket_table = bucket_table
        self.max_admit_wait = max_admit_wait
        self.slots = [BatchSlot() for _ in range(batch_size)]
        self.queue: List[Request] = []
        self.step_idx = 0
        self.completed: List[Request] = []
        self._admit_calls = 0
        self._enqueued_at: Dict[int, int] = {}  # id(req) -> admit-call no.

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self._enqueued_at[id(req)] = self._admit_calls

    def _place(self, req: Request, filled: List[int]) -> None:
        i = next(j for j, s in enumerate(self.slots) if s.request is None)
        self.slots[i].request = req
        self.slots[i].pos = len(req.prompt)
        self.slots[i].prefilling = False
        self._enqueued_at.pop(id(req), None)
        filled.append(i)

    def admit(self) -> Tuple[List[int], List[int]]:
        """Recycle done slots and admit queued requests into free slots.

        Returns (freed, filled) slot-index lists: `freed` are slots whose
        request just completed (their cache rows must be evicted before
        reuse); `filled` are slots newly holding an admitted request,
        which needs a prefill before it can join decode. A slot can
        appear in both lists (recycled and immediately refilled).

        Without a bucket table admission is plain FIFO. With one, the
        head of the queue anchors a same-bucket cohort (gathered in FIFO
        order from anywhere in the queue — that coalescing past other
        buckets is the point of bucketing); the cohort is admitted when
        it fills every free slot, when the whole queue shares its bucket
        (no other bucket to wait behind), or when the head has waited
        `max_admit_wait` admit calls (starvation cap). Holding a cohort
        blocks admission for that call, so the queue HEAD is never
        overtaken; a non-head request of another bucket can be, but only
        until it reaches the head, where the same cap bounds its wait.
        """
        freed = self.recycle()
        filled: List[int] = []
        self._admit_calls += 1
        if self.bucket_table is None:
            while self.queue and any(s.request is None for s in self.slots):
                self._place(self.queue.pop(0), filled)
            return freed, filled
        while self.queue:
            n_free = sum(s.request is None for s in self.slots)
            if n_free == 0:
                break
            head = self.queue[0]
            wb = self.bucket_table.bucket_of(head.prompt_len)
            cohort_pos = [
                j for j, r in enumerate(self.queue)
                if self.bucket_table.bucket_of(r.prompt_len) == wb
            ][:n_free]
            waited = self._admit_calls - self._enqueued_at.get(
                id(head), self._admit_calls
            )
            full = (len(cohort_pos) == n_free
                    or len(cohort_pos) == len(self.queue))
            if not full and waited < self.max_admit_wait:
                break  # hold the partial cohort for same-bucket arrivals
            cohort = [self.queue[j] for j in cohort_pos]
            taken = set(cohort_pos)
            self.queue = [r for j, r in enumerate(self.queue) if j not in taken]
            for r in cohort:
                self._place(r, filled)
        return freed, filled

    def recycle(self) -> List[int]:
        """Move done requests to `completed`, freeing their slots."""
        freed: List[int] = []
        for i, s in enumerate(self.slots):
            if s.request is not None and s.request.done:
                self.completed.append(s.request)
                s.request = None
                s.prefilling = False
                freed.append(i)
        return freed

    def _fill_slots(self) -> None:
        self.admit()

    def active_group(self) -> int:
        return self.step_idx % self.n_groups

    def group_slots(self, g: int) -> List[int]:
        """Slot indices owned by zigzag group g (fixed width)."""
        width = self.batch_size // self.n_groups
        return list(range(g * width, (g + 1) * width))

    def next_group(self):
        """Fixed-width view of the active zigzag group for shape-stable
        stepping: (group, slot_indices, tokens [W,1], pos [W], live [W]).

        Unlike next_batch, dead slots stay in the batch (tokens/pos 0,
        live False) so the jitted decode step compiles once per group
        width; callers mask with `live` when recording. Slots still
        mid-prefill (chunked piggyback admission) are dead too — their
        cache rows are incomplete until the last chunk lands. Advances
        the rotation; returns None when the whole group is idle.
        """
        g = self.active_group()
        idxs = self.group_slots(g)
        self.step_idx += 1
        toks = np.zeros((len(idxs), 1), np.int32)
        pos = np.zeros((len(idxs),), np.int32)
        live = np.zeros((len(idxs),), bool)
        for row, i in enumerate(idxs):
            r = self.slots[i].request
            if r is None or r.done or self.slots[i].prefilling:
                continue
            toks[row, 0] = r.generated[-1] if r.generated else int(r.prompt[-1])
            pos[row] = self.slots[i].pos
            live[row] = True
        if not live.any():
            return None
        return g, idxs, toks, pos, live

    def next_batch(self):
        """Returns (slot_indices, tokens [G, 1]) for the active zigzag
        group, or None when idle. Tokens are the last generated (or last
        prompt) token per slot."""
        self._fill_slots()
        g = self.active_group()
        width = self.batch_size // self.n_groups
        idxs = list(range(g * width, (g + 1) * width))
        toks = []
        live = []
        for i in idxs:
            r = self.slots[i].request
            if r is None or r.done:
                continue
            last = r.generated[-1] if r.generated else int(r.prompt[-1])
            toks.append(last)
            live.append(i)
        self.step_idx += 1
        if not live:
            return None
        return live, np.asarray(toks, np.int32)[:, None]

    def record(self, slot_indices: List[int], new_tokens: np.ndarray) -> None:
        for i, tok in zip(slot_indices, new_tokens.reshape(-1)):
            r = self.slots[i].request
            r.generated.append(int(tok))
            self.slots[i].pos += 1

    @property
    def utilization(self) -> float:
        live = sum(s.request is not None and not s.request.done for s in self.slots)
        return live / self.batch_size
