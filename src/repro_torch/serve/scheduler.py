"""Request-queue scheduler with continuous batching (twin of
``repro.serve.scheduler``).

``submit()`` enqueues at any time; ``step()`` admits in strict FIFO
order (a fixed-capacity KV pool defers the head until slots free up) and
advances every active sequence one token: one decode wave, the
speculation harvest (when the engine speculates), one batched search,
one finish. Sequences finish independently, settle their speculation
points, and free their slots for queued work. With a per-sequence engine
(``engine.wave`` False) the step decodes each request on its own, then
issues every due query, flushes them as one search, and finishes each
request.

``cancel()`` drops a queued request or flags an active one, which
finishes (``cancelled=True``, slots released) at the next step. The
queue's depth, head-of-line age and per-tenant depths
(``queue_stats()``) are the gateway's backpressure signals.

Each wave's wall time feeds a ``StragglerMonitor``: a wave slower than
2x the rolling median of the last 32 bumps ``straggler_events`` and
drops a ``sched.straggler`` trace instant. The phases are spans on the
tracer's "wave" track, nested under one ``sched.step`` per wave.
"""
from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, Dict, List, Optional

from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.serve.api import RalmRequest, RalmResponse

if TYPE_CHECKING:
    from repro_torch.serve.engine import RalmEngine


class RalmScheduler:
    """FIFO admission + lockstep wave steps; ``max_active`` bounds the
    requests in flight (``None`` admits everything)."""

    def __init__(self, engine: "RalmEngine",
                 max_active: Optional[int] = None):
        self.engine = engine
        self.max_active = max_active
        self.queue: deque = deque()
        self.active: list = []
        self._next_id = 0
        self._issued: set = set()
        # wave-duration outliers: a wave over 2x the recent median
        # usually means a retrieval stall or a KV-pool growth
        self.straggler = StragglerMonitor(threshold=2.0, window=32)
        self.straggler_events = 0
        self._wave_idx = 0

    def submit(self, request: RalmRequest) -> int:
        """Enqueue a request; returns its id. A request that can never be
        admitted is rejected now rather than wedging the queue."""
        self.engine.check_admissible(request)
        if request.request_id is None:
            request.request_id = self._next_id
        elif request.request_id in self._issued:
            raise ValueError(
                f"request_id {request.request_id} already issued")
        self._issued.add(request.request_id)
        self._next_id = max(self._next_id, request.request_id) + 1
        if request.trace_id is None:
            # the flow id linking this request's trace events across
            # tracks; request_id is already unique per engine
            request.trace_id = request.request_id
        if request.times.arrival is None:
            request.times.arrival = time.perf_counter()
        self.queue.append(request)
        return request.request_id

    def cancel(self, request_id: int) -> bool:
        """Abort a request: a queued one is dropped now (no response); an
        active one is flagged and finishes at the next ``step()`` with
        ``cancelled=True`` and its slots released. Returns whether the id
        named a live request. Call from the thread that runs ``step()``
        (the scheduler takes no lock)."""
        for i, req in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[i]     # by position, as in AdmissionController
                return True
        for seq in self.active:
            if seq.request.request_id == request_id:
                seq.request.cancelled = True
                return True
        return False

    def _admit(self) -> None:
        while self.queue and (self.max_active is None or
                              len(self.active) < self.max_active):
            if not self.engine.can_admit(self.queue[0]):
                break   # strict FIFO: a deferred head blocks later work
            self.active.append(self.engine.start(self.queue.popleft()))

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    @property
    def num_active(self) -> int:
        return len(self.active)

    # -- queue observability (the gateway's backpressure signal) -----------

    @property
    def queued_requests(self) -> int:
        """Requests submitted but not yet started."""
        return len(self.queue)

    def queue_age_max_s(self, now: Optional[float] = None) -> float:
        """Age of the oldest queued request (0.0 when the queue is
        empty): the wait a newly arriving request signs up behind."""
        if not self.queue:
            return 0.0
        now = time.perf_counter() if now is None else now
        oldest = min((r.times.arrival for r in self.queue
                      if r.times.arrival is not None), default=now)
        return max(0.0, now - oldest)

    def tenant_depths(self) -> Dict[str, int]:
        """Queued requests per tenant (active ones already hold slots)."""
        depths: Dict[str, int] = {}
        for req in self.queue:
            depths[req.tenant] = depths.get(req.tenant, 0) + 1
        return depths

    def queue_stats(self, now: Optional[float] = None) -> Dict[str, object]:
        """One snapshot for /statsz and the degrade policy."""
        return dict(
            queued_requests=self.queued_requests,
            active_requests=self.num_active,
            active_rows=sum(seq.cur.shape[0] for seq in self.active),
            queue_age_max_s=self.queue_age_max_s(now),
            tenant_depth=self.tenant_depths(),
        )

    def step(self) -> List[RalmResponse]:
        """Advance every active sequence one token; returns the requests
        that completed on this step (a cancelled one among them)."""
        self._admit()
        finished: List[RalmResponse] = []
        # a steps <= 0 request is complete at admission (prompt only), a
        # cancelled one as soon as this step sees it
        already_done = [s for s in self.active if s.done]
        self.active = [s for s in self.active if not s.done]
        for seq in already_done:
            self.engine.release(seq)
            finished.append(self._response(seq))
        if not self.engine.wave:
            return finished + self._step_per_sequence()
        return finished + self._step_wave()

    def _step_per_sequence(self) -> List[RalmResponse]:
        """The per-sequence loop: one decode per request, every due query
        issued, one flush for all of them, then each request's finish."""
        eng = self.engine
        pending = [(seq, *eng.dispatch_decode(seq)) for seq in self.active]
        searches = [eng.dispatch_search(seq, hidden)
                    for seq, _, hidden in pending]
        eng.flush_searches()
        finished: List[RalmResponse] = []
        still_active = []
        for (seq, logits, hidden), search in zip(pending, searches):
            eng.finish_step(seq, logits, hidden, search=search)
            if seq.done:
                eng.release(seq)
                finished.append(self._response(seq))
            else:
                still_active.append(seq)
        self.active = still_active
        return finished

    def _step_wave(self) -> List[RalmResponse]:
        eng = self.engine
        tr = eng.tracer
        t_wave = time.perf_counter()
        with tr.span("sched.step", "wave",
                     args={"active": len(self.active)}
                     if tr.enabled else None):
            decoded = eng.dispatch_wave(self.active)
            if eng.speculate_k > 0:
                # verify the points whose real search has had its waves
                # to land: AFTER the next decode is enqueued (the overlap
                # that hides the scan) and BEFORE the search phase (so an
                # accepted point's real neighbours seed this wave's
                # speculations)
                eng.spec_harvest(self.active, decoded)
            with tr.span("wave.search", "wave"):
                searches = eng.dispatch_search_wave(self.active, decoded)
                eng.flush_searches()
            with tr.span("wave.finish", "wave"):
                eng.finish_wave(self.active, decoded, searches)
        if self.active:
            self._record_wave(time.perf_counter() - t_wave)
        finished: List[RalmResponse] = []
        still_active = []
        for seq in self.active:
            if seq.done:
                # settle outstanding speculation before the response
                # leaves: the parity guarantee is per response
                eng.spec_finalize(seq)
                eng.release(seq)
                finished.append(self._response(seq))
            else:
                still_active.append(seq)
        self.active = still_active
        return finished

    def _record_wave(self, duration_s: float) -> None:
        """Feed one wave's wall time (host time: on the card it waits
        for the device only where the wave syncs) into the straggler
        monitor; an outlier bumps the counter the metrics adapter
        exports and drops a trace instant."""
        self._wave_idx += 1
        event = self.straggler.record(self._wave_idx, duration_s)
        if event is None:
            return
        self.straggler_events += 1
        tr = self.engine.tracer
        if tr.enabled:
            tr.instant("sched.straggler", "wave",
                       args={"wave": event.step,
                             "duration_ms": event.duration * 1e3,
                             "median_ms": event.median * 1e3,
                             "ratio": event.ratio})

    @staticmethod
    def _response(seq) -> RalmResponse:
        seq.request.times.finish = time.perf_counter()
        return RalmResponse(
            request_id=seq.request.request_id,
            tokens=seq.tokens().cpu().numpy(), steps=seq.step,
            trace=seq.request.trace, tenant=seq.request.tenant,
            cancelled=seq.request.cancelled, times=seq.request.times,
            partial_steps=seq.request.partial_steps)

    def run(self) -> List[RalmResponse]:
        """Drain the queue: step until nothing is queued or active."""
        out: List[RalmResponse] = []
        while self.has_work:
            out.extend(self.step())
        return out
