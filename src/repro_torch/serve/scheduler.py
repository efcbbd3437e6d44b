"""Request-queue scheduler with continuous batching (twin of
``repro.serve.scheduler``, wave path).

``submit()`` enqueues at any time; ``step()`` admits in strict FIFO
order (a fixed-capacity KV pool defers the head until slots free up) and
advances every active sequence one token: one decode wave, one batched
search, one finish. Sequences finish independently and free their slots
for queued work.
"""
from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, List, Optional

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
        decoded = eng.dispatch_wave(self.active)
        searches = eng.dispatch_search_wave(self.active, decoded)
        eng.flush_searches()
        eng.finish_wave(self.active, decoded, searches)
        finished: List[RalmResponse] = []
        still_active = []
        for seq in self.active:
            if seq.done:
                eng.release(seq)
                finished.append(self._response(seq))
            else:
                still_active.append(seq)
        self.active = still_active
        return finished

    @staticmethod
    def _response(seq) -> RalmResponse:
        seq.request.times.finish = time.perf_counter()
        return RalmResponse(
            request_id=seq.request.request_id,
            tokens=seq.tokens().cpu().numpy(), steps=seq.step,
            trace=seq.request.trace, times=seq.request.times)

    def run(self) -> List[RalmResponse]:
        """Drain the queue: step until nothing is queued or active."""
        out: List[RalmResponse] = []
        while self.has_work:
            out.extend(self.step())
        return out
