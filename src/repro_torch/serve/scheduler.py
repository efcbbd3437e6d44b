"""Request-queue scheduler with continuous batching (twin of
``repro.serve.scheduler``, wave path).

``submit()`` enqueues at any time; ``step()`` admits in strict FIFO
order (a fixed-capacity KV pool defers the head until slots free up) and
advances every active sequence one token: one decode wave, the
speculation harvest (when the engine speculates), one batched search,
one finish. Sequences finish independently, settle their speculation
points, and free their slots for queued work.

Each wave's wall time feeds a ``StragglerMonitor``: a wave slower than
2x the rolling median of the last 32 bumps ``straggler_events`` and
drops a ``sched.straggler`` trace instant. The phases are spans on the
tracer's "wave" track, nested under one ``sched.step`` per wave.
"""
from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, List, Optional

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
        if request.times.arrival is None:
            request.times.arrival = time.perf_counter()
        self.queue.append(request)
        return request.request_id

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

    def step(self) -> List[RalmResponse]:
        """Advance every active sequence one token; returns the requests
        that completed on this step."""
        self._admit()
        finished: List[RalmResponse] = []
        already_done = [s for s in self.active if s.done]
        self.active = [s for s in self.active if not s.done]
        for seq in already_done:
            self.engine.release(seq)
            finished.append(self._response(seq))
        return finished + self._step_wave()

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
            trace=seq.request.trace, times=seq.request.times,
            partial_steps=seq.request.partial_steps)

    def run(self) -> List[RalmResponse]:
        """Drain the queue: step until nothing is queued or active."""
        out: List[RalmResponse] = []
        while self.has_work:
            out.extend(self.step())
        return out
