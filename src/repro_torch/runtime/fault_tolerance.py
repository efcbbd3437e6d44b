"""Straggler detection (twin of the serving half of
``repro.runtime.fault_tolerance``).

Slow steps are detected from step-time statistics, not gossip: a step
slower than ``threshold`` x the rolling median of the last ``window``
steps is a straggler. The scheduler feeds it each decode wave's wall
time (``RalmScheduler._record_wave``). The training half of the
reference module (``TrainController``, ``SimulatedFailure``,
``elastic_restore``) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

__all__ = ["StragglerEvent", "StragglerMonitor"]


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    ratio: float


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x rolling median.

    The first five steps are never flagged (no history yet), so a slow
    first wave — on the card, the one that builds the kernels — is not
    an event; it still sits in the median of the next ``window`` steps.
    The mitigation callback records the event and lets the caller
    decide."""

    def __init__(self, threshold: float = 2.0, window: int = 32,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.threshold = threshold
        self.window = window
        self.on_straggler = on_straggler
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []

    def record(self, step: int, duration: float) -> Optional[StragglerEvent]:
        hist = self.durations[-self.window:]
        self.durations.append(duration)
        if len(hist) < 5:
            return None
        med = float(np.median(hist))
        if duration > self.threshold * med:
            ev = StragglerEvent(step, duration, med, duration / med)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            return ev
        return None
