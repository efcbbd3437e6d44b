"""Shard replica groups: the health state machine behind fault-tolerant
retrieval dispatch (twin of ``repro.retrieval.replica``).

Chameleon disaggregates the vector-search tier so it can scale
independently of the LM tier (paper §3) — which also makes it an
independent *failure domain*: a hung or crashed ChamVS shard must not
stall every decode wave behind the retrieval flush. This module owns
the control-plane half of the answer: each fault domain (a shard of
``LocalPipeline``) has a group of dispatch-target replicas, each with a
health state machine driven by per-dispatch outcome reports:

    healthy --bad x suspect_after--> suspect
    suspect --bad x eject_after----> ejected      (crash: any -> ejected)
    ejected --probation_s cool-off-> probation    (probe traffic resumes)
    probation --ok x probation_successes--> healthy   (a "recovery")
    probation --any bad------------> ejected      (failed probe)

``pick()`` is the dispatch router: healthy replicas round-robin;
suspect and probation-due replicas receive probe traffic every
``probe_every`` picks (so a benched replica can either re-prove itself
or finish failing toward ejection while healthy peers carry the load);
suspects otherwise serve only when nothing better exists.
``hedge_delay_s()`` is the quantile of observed dispatch latencies —
the delay after which ``RetrievalService`` hedges a hung dispatch to
another replica (the classic tail-at-scale hedged-request rule).

In-process the replicas are *dispatch-target bookkeeping*, not copies
of the shard data: all replicas of a domain answer from the same
arrays, so a failover re-serves bit-identical candidates. What this
layer models faithfully is the control plane — which target is asked,
when the service gives up on it, and how latency/ejection accounting
evolves — which is exactly what the chaos tests exercise. A
multi-host deployment would back each replica id with a real copy;
nothing in the state machine changes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.obs.metrics import Reservoir

__all__ = ["FailoverConfig", "ReplicaGroup", "ReplicaHealth",
           "HEALTHY", "SUSPECT", "EJECTED", "PROBATION"]

HEALTHY = "healthy"
SUSPECT = "suspect"
EJECTED = "ejected"
PROBATION = "probation"

#: outcomes a dispatch can report; everything but "ok" counts against
#: the replica ("slow" = completed past the per-dispatch deadline,
#: "timeout" = never answered before the hedge fired, "error" = a
#: transient failure worth retrying, "crash" = the process is gone)
OUTCOMES = ("ok", "slow", "timeout", "error", "crash")


@dataclasses.dataclass(frozen=True)
class FailoverConfig:
    """Knobs of the fault-tolerant dispatch layer (``ServiceConfig.
    failover``). ``replicas`` is per fault domain; the deadline/hedge
    fields govern ``RetrievalService._dispatch_scan``; the rest drive
    the health state machine above."""
    replicas: int = 2             # dispatch targets per fault domain
    dispatch_deadline_s: float = 0.0  # per-dispatch latency budget; a
    #                               dispatch still pending past it stops
    #                               failing over and serves partial
    #                               results (0 = no deadline)
    hedge_quantile: float = 0.95  # latency quantile after which a hung
    #                               dispatch is hedged to another replica
    hedge_floor_s: float = 0.005  # hedge delay floor while the latency
    #                               reservoir is still cold
    suspect_after: int = 1        # consecutive bad outcomes -> suspect
    eject_after: int = 3          # consecutive bad outcomes -> ejected
    probation_s: float = 1.0      # cool-off before an ejected replica
    #                               becomes probe-eligible again
    probation_successes: int = 2  # consecutive probe successes -> healthy
    probe_every: int = 4          # send probe traffic to a probation-due
    #                               replica every N picks (healthy peers
    #                               carry the rest)
    max_retries: int = 1          # transient-error retries per replica
    #                               within one dispatch
    backoff_s: float = 0.0        # base retry backoff (doubles per retry)
    sleep_cap_s: float = 0.25     # cap on any single real-time chaos/
    #                               hedge/backoff sleep
    allow_partial: bool = True    # serve exact top-k over the surviving
    #                               domains when a domain is down past
    #                               the deadline; False raises instead


@dataclasses.dataclass
class ReplicaHealth:
    """Per-(domain, replica) state machine cell."""
    state: str = HEALTHY
    consec_fail: int = 0
    consec_ok: int = 0
    ejected_at: float = 0.0
    dispatches: int = 0
    failures: int = 0


class ReplicaGroup:
    """Health-tracked dispatch targets for every fault domain of one
    pipeline. ``clock`` is injectable so tests drive probation cool-off
    without sleeping; ``on_transition(domain, replica, old, new)`` lets
    the owning service count ejections/recoveries and emit trace
    instants without this module importing the tracer."""

    def __init__(self, num_shards: int, cfg: FailoverConfig,
                 clock: Callable[[], float] = time.perf_counter,
                 on_transition: Optional[
                     Callable[[int, int, str, str], None]] = None):
        if num_shards < 1 or cfg.replicas < 1:
            raise ValueError(f"need >= 1 shard and >= 1 replica, got "
                             f"{num_shards} x {cfg.replicas}")
        self.num_shards = num_shards
        self.cfg = cfg
        self.clock = clock
        self.sleep: Callable[[float], None] = time.sleep
        self.on_transition = on_transition
        self.health: Dict[Tuple[int, int], ReplicaHealth] = {
            (s, r): ReplicaHealth()
            for s in range(num_shards) for r in range(cfg.replicas)}
        self._rr = [0] * num_shards
        self.latency = Reservoir(cap=512)
        self.ejections = 0
        self.recoveries = 0
        self.transitions: List[Dict[str, object]] = []   # bounded log

    # -- dispatch routing ---------------------------------------------------

    def pick(self, shard: int, exclude: Optional[Set[int]] = None
             ) -> Optional[int]:
        """Choose the dispatch target for ``shard``, skipping
        ``exclude`` (replicas already tried this dispatch). Returns
        ``None`` when every remaining replica is ejected and not yet
        probation-due — the shard is down."""
        exclude = exclude or set()
        cand = [r for r in range(self.cfg.replicas) if r not in exclude]
        if not cand:
            return None
        self._rr[shard] += 1
        now = self.clock()
        healthy, suspect, probing = [], [], []
        for r in cand:
            h = self.health[(shard, r)]
            if h.state == HEALTHY:
                healthy.append(r)
            elif h.state == SUSPECT:
                suspect.append(r)
            elif h.state == PROBATION:
                probing.append(r)
            elif h.state == EJECTED and \
                    now - h.ejected_at >= self.cfg.probation_s:
                probing.append(r)      # cool-off served: probe-eligible
        # probe cadence: when probe-eligible or suspect replicas exist,
        # divert every probe_every-th pick to one — otherwise a benched
        # replica never gets the traffic it needs to recover (suspect +
        # ok -> healthy) or to finish failing (suspect + bad x
        # eject_after -> ejected) while healthy peers carry the load
        revisit = probing + suspect
        if revisit and (not healthy or
                        self._rr[shard] % self.cfg.probe_every == 0):
            return self._begin_probe(shard, revisit[0], now)
        if healthy:
            return healthy[self._rr[shard] % len(healthy)]
        if suspect:
            return suspect[self._rr[shard] % len(suspect)]
        if probing:
            return self._begin_probe(shard, probing[0], now)
        return None

    def _begin_probe(self, shard: int, r: int, now: float) -> int:
        h = self.health[(shard, r)]
        if h.state == EJECTED:
            self._transition(shard, r, h, PROBATION, now)
            h.consec_ok = 0
            h.consec_fail = 0
        return r

    # -- outcome reporting --------------------------------------------------

    def report(self, shard: int, replica: int, outcome: str,
               latency_s: Optional[float] = None) -> None:
        """Feed one dispatch outcome into the state machine. ``latency_s``
        (successful dispatches) feeds the hedge-delay quantile."""
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}")
        h = self.health[(shard, replica)]
        h.dispatches += 1
        now = self.clock()
        if latency_s is not None:
            self.latency.add(latency_s)
        if outcome == "ok":
            h.consec_fail = 0
            h.consec_ok += 1
            if h.state == SUSPECT:
                self._transition(shard, replica, h, HEALTHY, now)
            elif h.state == PROBATION and \
                    h.consec_ok >= self.cfg.probation_successes:
                self._transition(shard, replica, h, HEALTHY, now)
            return
        h.failures += 1
        h.consec_ok = 0
        if outcome == "crash":
            h.consec_fail = 0
            h.ejected_at = now
            if h.state != EJECTED:
                self._transition(shard, replica, h, EJECTED, now)
            return
        h.consec_fail += 1
        if h.state == PROBATION or h.consec_fail >= self.cfg.eject_after:
            h.ejected_at = now                       # failed probe, or
            h.consec_fail = 0                        # chronic failures
            if h.state != EJECTED:
                self._transition(shard, replica, h, EJECTED, now)
        elif h.state == HEALTHY and \
                h.consec_fail >= self.cfg.suspect_after:
            self._transition(shard, replica, h, SUSPECT, now)

    def _transition(self, shard: int, replica: int, h: ReplicaHealth,
                    new: str, now: float) -> None:
        old, h.state = h.state, new
        if new == EJECTED:
            self.ejections += 1
        if old == PROBATION and new == HEALTHY:
            self.recoveries += 1
        if len(self.transitions) < 256:
            self.transitions.append(dict(
                t=now, shard=shard, replica=replica, old=old, new=new))
        if self.on_transition is not None:
            self.on_transition(shard, replica, old, new)

    # -- hedging ------------------------------------------------------------

    def hedge_delay_s(self) -> float:
        """Quantile-based hedge delay (tail-at-scale): hedge a pending
        dispatch once it has outlived the ``hedge_quantile`` of observed
        latencies; floor while the reservoir is cold."""
        q = self.latency.quantile(self.cfg.hedge_quantile)
        return max(q, self.cfg.hedge_floor_s)

    # -- observability ------------------------------------------------------

    def live_domains(self) -> List[bool]:
        """Per-domain liveness: at least one replica not ejected (an
        ejected-but-probation-due replica counts as live: it can still
        be dispatched to)."""
        now = self.clock()
        out = []
        for s in range(self.num_shards):
            live = False
            for r in range(self.cfg.replicas):
                h = self.health[(s, r)]
                if h.state != EJECTED or \
                        now - h.ejected_at >= self.cfg.probation_s:
                    live = True
                    break
            out.append(live)
        return out

    def state_counts(self) -> Dict[str, int]:
        counts = {HEALTHY: 0, SUSPECT: 0, EJECTED: 0, PROBATION: 0}
        for h in self.health.values():
            counts[h.state] += 1
        return counts

    def snapshot(self) -> Dict[str, object]:
        return dict(
            num_shards=self.num_shards,
            replicas=self.cfg.replicas,
            states=self.state_counts(),
            ejections=self.ejections,
            recoveries=self.recoveries,
            hedge_delay_s=self.hedge_delay_s(),
            transitions=list(self.transitions[-32:]),
            per_replica={
                f"{s}/{r}": dict(state=h.state,
                                 dispatches=h.dispatches,
                                 failures=h.failures)
                for (s, r), h in self.health.items()},
        )
