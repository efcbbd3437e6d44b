"""Deterministic fault injection for the retrieval tier (twin of
``repro.retrieval.chaos``: one plan injects the same faults in both
packages).

Real shard failure cannot happen in CI, so every failure mode the
fault-tolerance layer claims to survive is *injected* here,
reproducibly: a seeded ``FaultPlan`` decides, per (flush, fault domain,
replica, attempt), whether a dispatch hangs, crashes, errors
transiently, or runs slow — and the decision is a pure function of the
plan, so two runs with the same plan and request stream observe the
same fault sequence regardless of wall-clock jitter.

The injection point is the pipeline ``scan`` boundary inside
``RetrievalService._dispatch_scan``: the service consults
``ChaosInjector.outcome(...)`` for the replica it is about to charge
with the dispatch, and the returned fault shapes what the dispatch
loop sees —

  * ``hang``  — the replica never answers; the service waits out the
    quantile-based hedge delay and re-dispatches (a *hedge*);
  * ``crash`` — the replica is gone; instant failover + ejection;
  * ``error`` — transient failure; retry-with-backoff on the same
    replica, failover once ``max_retries`` is spent;
  * ``slow``  — the dispatch completes but ``slow_s`` late; late
    completions past the per-dispatch deadline count as timeouts and
    feed the suspect/eject machine.

``FaultPlan.realtime`` decides whether modeled latencies (hedge waits,
slowdowns, backoffs) are also *slept*, so that latency under faults is
honest wall-clock; the tests keep ``realtime=False`` and assert on the
modeled accounting, so the chaos suite runs in milliseconds.

Plans round-trip through JSON (``EngineConfig.chaos_plan`` names such
a file; the reference package reads and writes the same format)::

    {"seed": 0, "realtime": false,
     "faults": [{"kind": "crash", "shard": 0, "replica": 0,
                 "start_flush": 8, "stop_flush": 24, "p": 1.0}]}
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FaultKind", "FaultSpec", "FaultPlan", "ChaosInjector",
           "ScanHang", "ReplicaCrash", "TransientScanError"]

#: the injectable failure modes
FaultKind = ("hang", "crash", "error", "slow")


class ScanHang(TimeoutError):
    """A dispatch that never answered (surfaced only when the dispatch
    loop has no replica left to hedge to and partials are disabled)."""


class ReplicaCrash(RuntimeError):
    """A dispatch whose target process died."""


class TransientScanError(RuntimeError):
    """A dispatch that failed but is worth retrying."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule. ``shard``/``replica`` of -1 match any fault
    domain / any replica; the flush window is [start_flush, stop_flush)
    with ``stop_flush=-1`` meaning forever; ``p`` is the per-dispatch
    injection probability (sampled deterministically — see
    ``ChaosInjector.outcome``). ``slow_s`` is the added latency for
    ``kind="slow"`` (a fixed slowdown; fractional slowdowns come from
    ``p < 1``: only that fraction of dispatches is slowed)."""
    kind: str
    shard: int = -1
    replica: int = -1
    start_flush: int = 0
    stop_flush: int = -1
    p: float = 1.0
    slow_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FaultKind:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FaultKind}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")

    def matches(self, flush: int, shard: int, replica: int) -> bool:
        if self.shard >= 0 and shard != self.shard:
            return False
        if self.replica >= 0 and replica != self.replica:
            return False
        if flush < self.start_flush:
            return False
        return self.stop_flush < 0 or flush < self.stop_flush

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded set of injection rules. First matching rule wins (rule
    order is declaration order), so a plan can carve exceptions by
    listing a narrower rule first."""
    faults: Tuple[FaultSpec, ...] = ()
    seed: int = 0
    realtime: bool = False    # sleep the modeled latencies for honest
    #                           wall-clock; False keeps the
    #                           accounting but never sleeps (tests)

    @staticmethod
    def make(faults: Sequence[FaultSpec], seed: int = 0,
             realtime: bool = False) -> "FaultPlan":
        return FaultPlan(faults=tuple(faults), seed=seed,
                         realtime=realtime)

    # -- JSON round-trip (the EngineConfig.chaos_plan surface) -------------

    def to_json(self) -> str:
        return json.dumps(dict(
            seed=self.seed, realtime=self.realtime,
            faults=[f.as_dict() for f in self.faults]), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        obj = json.loads(text)
        return cls(faults=tuple(FaultSpec(**f)
                                for f in obj.get("faults", ())),
                   seed=int(obj.get("seed", 0)),
                   realtime=bool(obj.get("realtime", False)))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as fh:
            return cls.from_json(fh.read())


class ChaosInjector:
    """Evaluates a ``FaultPlan`` at the scan boundary.

    Determinism contract: the outcome for a given (flush, shard,
    replica, attempt) is a pure function of the plan — each probability
    draw uses ``np.random.default_rng`` seeded with exactly that tuple
    (plus the rule index), so outcomes are independent of dispatch
    order, wall-clock, and each other. Two services running the same
    plan over the same request stream inject the same faults — in this
    package and in the reference alike, because the draw is numpy's
    (never a torch generator).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injected: Dict[str, int] = {k: 0 for k in FaultKind}

    def outcome(self, flush: int, shard: int, replica: int,
                attempt: int = 0) -> Optional[FaultSpec]:
        """The fault (if any) this dispatch suffers; ``None`` = healthy."""
        for idx, spec in enumerate(self.plan.faults):
            if not spec.matches(flush, shard, replica):
                continue
            if spec.p < 1.0:
                rng = np.random.default_rng(
                    [self.plan.seed, idx, flush, shard, replica, attempt])
                if rng.random() >= spec.p:
                    continue
            self.injected[spec.kind] += 1
            return spec
        return None

    def counts(self) -> Dict[str, int]:
        return dict(self.injected)


def crash_plan(shard: int = -1, replica: int = 0, start: int = 0,
               stop: int = -1, seed: int = 0,
               realtime: bool = False) -> FaultPlan:
    """Convenience: the 1-of-N-replicas-crashed scenario."""
    return FaultPlan.make(
        [FaultSpec(kind="crash", shard=shard, replica=replica,
                   start_flush=start, stop_flush=stop)],
        seed=seed, realtime=realtime)
