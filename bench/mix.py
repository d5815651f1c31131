"""Traffic as data: a mix is a file `bench/traffic/<mix>.json` of
parameters. Its `generator` names the module `bench/traffic/<generator>.py`
that turns the parameters, the configuration's vocabulary and a run's
`--seed` into requests; its `arrivals` group names the module
`bench/arrivals/<process>.py` that gives an open loop's gaps between
arrivals at the cell's rate. Both are found by name. A closed loop's
clients send as they are answered and read no arrival process. Imports
nothing of the program.

What the generators share is here: seeded generators keyed by integers,
lengths drawn from a mix's `{"min", "max"}` (uniform) or `{"min", "max",
"median", "sigma"}` (lognormal, clipped), tokens uniform or Zipf over a
permutation of the vocabulary that is redrawn every `phase_requests`
requests (`token_zipf`; topic phases), and the warm-up's prompts.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from spec import module_at

Request = Tuple[np.ndarray, int]  # (prompt tokens int32, max new tokens)


def rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) for k in key])


def lengths(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if "median" in spec:
        x = gen.lognormal(np.log(spec["median"]), spec["sigma"], n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    return gen.integers(lo, hi + 1, n)


class Generator:
    """A stream of requests: `request(k)` is the stream's k-th request,
    the same for every call; `prompt_range()` the shortest and longest
    prompt the mix can send."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, int(seed)
        self._phase = (None, None)

    def request(self, k: int) -> Request:
        raise NotImplementedError

    def prompt_range(self) -> Tuple[int, int]:
        raise NotImplementedError

    def longest_prompt(self) -> int:
        return self.prompt_range()[1]

    def tokens(self, n: int, gen: np.random.Generator, k: int) -> np.ndarray:
        """`n` tokens of the k-th request: uniform, or Zipf over the phase's
        permutation of the vocabulary."""
        a = self.mix.get("token_zipf")
        if a is None:
            return gen.integers(0, self.vocab, n).astype(np.int32)
        phase = k // int(self.mix["phase_requests"])
        if self._phase[0] != phase:
            self._phase = (phase, rng(self.seed, 2, phase).permutation(self.vocab))
        ranks = (gen.zipf(a, n) - 1) % self.vocab
        return self._phase[1][ranks].astype(np.int32)

    def warmup(self, n: int, max_new: int) -> List[Request]:
        """`n` requests of random tokens (no prefix shared with the stream),
        their prompt lengths spread over the mix's range, shortest to
        longest, so the warm-up visits the cell's prefill shapes."""
        lo, hi = self.prompt_range()
        lens = np.linspace(lo, hi, n).round().astype(int)
        gen = rng(self.seed, 10)
        return [(gen.integers(0, self.vocab, int(m)).astype(np.int32), max_new) for m in lens]


def traffic_of(bench_dir: Path, mix: dict, vocab: int, seed: int) -> Generator:
    """The mix's generator, found by its name."""
    return module_at(Path(bench_dir) / "traffic" / f"{mix['generator']}.py").Traffic(
        mix, vocab, seed)


def gaps_of(bench_dir: Path, mix: dict, seed: int, rate: float) -> Iterator[float]:
    """An open loop's gaps between arrivals, in seconds, mean 1 / rate, from
    the arrival process the mix names."""
    arrivals = mix.get("arrivals")
    if not arrivals:
        raise ValueError("an open loop needs the mix to name its arrival process")
    return module_at(Path(bench_dir) / "arrivals" / f"{arrivals['process']}.py").gaps(
        arrivals, rate, seed)
