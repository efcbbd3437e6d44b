"""Closed-loop traffic (a mix of ``"kind": "closed_loop"``).

Each of ``clients`` clients submits its next request the moment its last
one finishes (an offline job, or a fixed pool of readers); at the start
the clients join ``ramp`` a scheduler step. A request has ``rows``
prompt rows decoded in lockstep, one prompt length and one answer length,
from every ``prompt_step``-th value of ``prompt_len`` and every
``answer_step``-th of ``answer_len``. Client c's k-th request takes the
value at (phase_c + k * stride) mod n of each list: the clients' phases
are spread evenly over the values, and a stride near 0.38 n, prime to n,
sweeps each client across them. So at every moment the clients in
flight hold every length about equally, and a window's work does not
depend on the seed; the seed rotates the phases and pairs prompt phases
with answer phases. Prompt tokens are seeded uniform ids, made on the
device. Every ``trace_every``-th request (from an offset drawn from the
seed) records its neighbours' ids and distances for the correctness
check.

The pattern is ``benchmarks/loadgen.py``'s closed loop with seeded
lengths, rewritten to drive the port in-process.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ralm_bench.inputs import generator, sub_seed
from ralm_bench.traffic import Request

KEYS = ("clients", "rows", "prompt_len", "answer_len", "prompt_step",
        "answer_step", "ramp", "trace_every")


class _Sweep:
    """Client c's k-th value of ``values``: values[(phase_c + k * stride)
    mod n], the phases spread evenly over the values and rotated by
    ``shift``, in the client order ``order``."""

    def __init__(self, lo: int, hi: int, step: int, clients: int,
                 shift: int, order: np.ndarray):
        self.values = np.arange(lo, hi + 1, step)
        n = len(self.values)
        self.stride = next(s for s in sorted(range(1, n + 1),
                                             key=lambda s: abs(s - 0.38 * n))
                           if math.gcd(s, n) == 1)
        self.phase = (order * n // clients + shift) % n

    def __call__(self, client: int, k: int) -> int:
        n = len(self.values)
        return int(self.values[(self.phase[client] + k * self.stride) % n])


class Traffic:
    """Each client's requests: the first when it joins (``due``), the
    next when its last one finished (``after``)."""

    def __init__(self, mix: dict, seed: int, vocab: int, device):
        self.mix = mix
        self.vocab = vocab
        clients = mix["clients"]
        rng = np.random.default_rng(sub_seed(seed, "lengths"))
        self.prompt = _Sweep(*mix["prompt_len"], mix["prompt_step"], clients,
                             int(rng.integers(1 << 30)), np.arange(clients))
        self.answer = _Sweep(*mix["answer_len"], mix["answer_step"], clients,
                             int(rng.integers(1 << 30)),
                             rng.permutation(clients))
        self.trace_offset = int(rng.integers(mix["trace_every"]))
        self.gen = generator(seed, "prompts", device)
        self.device = device
        self.count = 0
        self.per_client = [0] * clients
        self.joined = 0
        self.warm = set()

    @property
    def max_seq(self) -> int:
        return int(self.prompt.values.max() + self.answer.values.max())

    @property
    def slots(self) -> int:
        return self.mix["clients"] * self.mix["rows"]

    @property
    def warmed(self) -> bool:
        """Every client has finished a request."""
        return len(self.warm) == self.mix["clients"]

    def due(self, now: float, steps: int) -> List[Request]:
        """The clients that join before step ``steps``: ``ramp`` a step."""
        upto = min(self.mix["clients"], self.mix["ramp"] * steps)
        out = [self.next(c) for c in range(self.joined, upto)]
        self.joined = max(self.joined, upto)
        return out

    def after(self, req: Request) -> List[Request]:
        self.warm.add(req.client)
        return [self.next(req.client)]

    def lengths(self, client: int, k: int) -> Tuple[int, int]:
        return self.prompt(client, k), self.answer(client, k)

    def next(self, client: int) -> Request:
        j, k = self.count, self.per_client[client]
        self.count += 1
        self.per_client[client] += 1
        t0, steps = self.lengths(client, k)
        prompt = torch.randint(0, self.vocab, (self.mix["rows"], t0),
                               generator=self.gen, device=self.device,
                               dtype=torch.int32)
        traced = (j + self.trace_offset) % self.mix["trace_every"] == 0
        return Request(j=j, client=client, prompt=prompt,
                       rows=self.mix["rows"], prompt_len=t0, steps=steps,
                       traced=traced, tokens=[] if traced else None,
                       neighbours=[] if traced else None)
