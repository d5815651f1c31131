"""Exponential gaps between arrivals, stratified: each block of `block`
gaps holds the exponential distribution's quantiles at (i + 0.5) / block,
scaled to mean 1 / rate, in an order the seed draws. Arrivals are as
bursty as a Poisson process's within a block, and every seed offers the
same load in every block."""
from typing import Iterator

import numpy as np


def gaps(params: dict, rate: float, seed: int) -> Iterator[float]:
    n = int(params["block"])
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    q = q / q.mean() / rate
    b = 0
    while True:
        yield from q[np.random.default_rng([int(seed), 9, b]).permutation(n)].tolist()
        b += 1
