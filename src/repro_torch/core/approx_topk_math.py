"""Sizing math for the approximate hierarchical priority queue (paper §4.2.2).

The paper's insight: with `num_queues` independent producers each keeping a
local top-`k'` queue, the probability that any single producer holds more than
`k'` of the global top-K results is a binomial tail. Truncating the level-one
queues from K to k' saves ~an order of magnitude of queue state (Fig. 8) while
returning results identical to exact K-selection for >= (1 - eps) of queries
(paper targets 99%).

Here the producers are the datastore shards; the math only depends on the
assumption that top-K elements land on producers uniformly at random — true
when clusters are striped evenly across shards (paper's partition scheme 1).
A pure-Python copy of ``repro.core.approx_topk_math``.
"""
from __future__ import annotations

import math


def binom_pmf(n: int, p: float, k: int) -> float:
    """P[Binomial(n, p) == k]."""
    if k < 0 or k > n:
        return 0.0
    return math.comb(n, k) * (p ** k) * ((1.0 - p) ** (n - k))


def binom_tail(n: int, p: float, k: int) -> float:
    """P[Binomial(n, p) > k]."""
    return max(0.0, 1.0 - sum(binom_pmf(n, p, i) for i in range(k + 1)))


def queue_overflow_prob(K: int, num_queues: int, k_prime: int) -> float:
    """P[at least one of `num_queues` L1 queues receives > k_prime of the top-K].

    Union bound over queues of the single-queue binomial tail (paper's p(k)/P(k),
    Fig. 7, made conservative via the union bound so the guarantee is a bound,
    not an approximation)."""
    tail = binom_tail(K, 1.0 / num_queues, k_prime)
    return min(1.0, num_queues * tail)


def truncated_queue_len(K: int, num_queues: int, eps: float = 0.01) -> int:
    """Smallest k' such that P[any L1 queue overflows] <= eps (paper: eps=1%).

    Monotone in k' -> linear scan (K is small, <= a few hundred)."""
    if num_queues <= 1:
        return K
    for k_prime in range(1, K + 1):
        if queue_overflow_prob(K, num_queues, k_prime) <= eps:
            return k_prime
    return K


def resource_saving(K: int, num_queues: int, eps: float = 0.01) -> float:
    """Fig. 8 metric: (exact L1 state) / (truncated L1 state). The exact
    hierarchical design needs num_queues * K entries, the approximate one
    num_queues * k'."""
    return K / truncated_queue_len(K, num_queues, eps)
