"""Per-tenant admission control for the serving front door (twin of
``repro.serve.gateway.admission``, which is stdlib-only; this is a copy,
not an import).

The engine already has the *inner* admission loop: ``engine.can_admit``
defers a request until KV-pool slots free up, in strict FIFO order.
That protects the pool, but it is the wrong layer for multi-tenant
traffic — one chatty tenant fills the FIFO and everyone else queues
behind it, and nothing ever says "no" to a client, so overload turns
into unbounded queue growth instead of backpressure.

This module is the *outer* loop, the one the paper's CPU coordinator
(§3) would run at the front door:

  * ``TokenBucket`` / ``TenantQuota`` — a per-tenant request-rate
    quota. An empty bucket is a **429** with ``Retry-After`` (the
    client is over its contract; shedding it protects everyone else);
  * queue-depth backpressure — when the total backlog (gateway pending
    + scheduler queue + active) exceeds ``max_queue_depth``, new work
    gets a **503** + ``Retry-After`` (the *system* is saturated;
    admitting more only grows tail latency — RAGO's TTFT-under-SLO
    lens says reject early);
  * per-tenant **fair dequeue** — accepted requests wait in per-tenant
    queues and are released to the scheduler round-robin across
    tenants, so the engine's strict-FIFO inner queue stays short and a
    burst from one tenant cannot monopolize admission order.

Pure host-side bookkeeping: no torch work, no threads of its own. The
gateway calls ``offer()`` from its HTTP handlers and ``take()`` from the
scheduler step loop; callers serialize access (the step loop is the
only consumer, handlers the only producers — a single lock in the
gateway covers both).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.serve.api import RalmRequest


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Request-rate contract of one tenant class.

    ``rate`` requests/second refill, up to ``burst`` banked. ``rate <=
    0`` means unmetered (admission is then bounded only by the global
    queue depth)."""
    rate: float = 0.0
    burst: float = 1.0


class TokenBucket:
    """Classic token bucket over a monotonic clock (injectable for
    tests). ``try_take`` either spends a token or reports how long
    until one is available (the 429's Retry-After)."""

    def __init__(self, quota: TenantQuota,
                 clock: Callable[[], float] = time.monotonic):
        self.quota = quota
        self._clock = clock
        self._tokens = float(quota.burst)
        self._last = clock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.quota.burst,
                           self._tokens + (now - self._last)
                           * self.quota.rate)
        self._last = now

    def try_take(self) -> Optional[float]:
        """Spend one token. Returns ``None`` on success, else the
        seconds until the next token (>= 0) for Retry-After."""
        if self.quota.rate <= 0:
            return None                      # unmetered tenant
        now = self._clock()
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return None
        return (1.0 - self._tokens) / self.quota.rate


@dataclasses.dataclass
class Verdict:
    """Outcome of ``offer()``: HTTP-shaped so the server maps it 1:1."""
    admitted: bool
    status: int = 200                 # 429 quota / 503 backpressure
    retry_after_s: float = 0.0
    reason: str = ""


class AdmissionController:
    """Front-door admission: quota check + backpressure bound at
    ``offer()``, per-tenant fair release at ``take()``."""

    def __init__(self, max_queue_depth: int = 64,
                 default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_queue_depth = max_queue_depth
        self.default_quota = default_quota or TenantQuota()
        self.quotas = dict(quotas or {})
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._queues: Dict[str, deque] = {}
        self._rr: List[str] = []          # round-robin tenant rotation
        # counters surfaced on /statsz and /metricsz
        self.admitted = 0
        self.rejected_quota = 0           # 429s
        self.rejected_capacity = 0        # 503s
        self.released = 0                 # handed to the scheduler

    # -- producer side (HTTP handlers) --------------------------------------

    def _bucket(self, tenant: str) -> TokenBucket:
        if tenant not in self._buckets:
            self._buckets[tenant] = TokenBucket(
                self.quotas.get(tenant, self.default_quota),
                clock=self._clock)
        return self._buckets[tenant]

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def tenant_pending(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def offer(self, request: RalmRequest, in_system: int = 0) -> Verdict:
        """Admit-or-reject one arriving request. ``in_system`` is the
        scheduler-side load (queued + active requests) so the depth
        bound covers the whole pipeline, not just this controller's
        queues. On admission the request is parked in its tenant's
        queue until ``take()`` releases it."""
        wait = self._bucket(request.tenant).try_take()
        if wait is not None:
            self.rejected_quota += 1
            return Verdict(False, status=429, retry_after_s=wait,
                           reason=f"tenant {request.tenant!r} over quota")
        if self.pending + in_system >= self.max_queue_depth:
            self.rejected_capacity += 1
            # a half-full queue drains in roughly (depth x service
            # time); without a latency estimate, 1s is an honest floor
            return Verdict(False, status=503, retry_after_s=1.0,
                           reason="queue depth bound reached")
        if request.tenant not in self._queues:
            self._queues[request.tenant] = deque()
            self._rr.append(request.tenant)
        self._queues[request.tenant].append(request)
        self.admitted += 1
        return Verdict(True)

    # -- consumer side (the scheduler step loop) ----------------------------

    def take(self, fits: Callable[[RalmRequest], bool]
             ) -> Optional[RalmRequest]:
        """Release the next request in round-robin tenant order whose
        head passes ``fits`` (the caller's capacity check — e.g. free
        KV rows). A tenant whose head does not fit is skipped this
        round rather than blocking everyone (the strict-FIFO inner
        queue stays short, so head-of-line blocking lives only inside
        one tenant's own queue)."""
        for _ in range(len(self._rr)):
            tenant = self._rr[0]
            self._rr.append(self._rr.pop(0))       # rotate
            q = self._queues.get(tenant)
            if q and fits(q[0]):
                self.released += 1
                return q.popleft()
        return None

    def cancel(self, request_id) -> bool:
        """Drop a still-pending request (client hung up before release).
        Returns whether the id was found here; a released request is the
        scheduler's to cancel."""
        for q in self._queues.values():
            for i, req in enumerate(q):
                if req.request_id == request_id:
                    # by position: ``q.remove(req)`` would compare the
                    # dataclass requests field by field, prompt tensors
                    # included, and raise on the first other request
                    del q[i]
                    return True
        return False

    def stats(self) -> Dict[str, object]:
        return dict(pending=self.pending,
                    tenant_pending=self.tenant_pending(),
                    admitted=self.admitted,
                    released=self.released,
                    rejected_quota=self.rejected_quota,
                    rejected_capacity=self.rejected_capacity)
