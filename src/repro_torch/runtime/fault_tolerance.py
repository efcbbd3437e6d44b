"""Fault-tolerant runtime (twin of ``repro.runtime.fault_tolerance``):
straggler detection, checkpoint/restart, elastic resume.

  1. A rank can die at any step and the run resumes bit-identically:
     atomic checkpoints and a stateless data order (``TrainController``;
     ``SimulatedFailure`` injects the loss).
  2. Slow steps are detected from step-time statistics, not gossip: a
     step slower than ``threshold`` x the rolling median of the last
     ``window`` steps is a straggler (``StragglerMonitor``). The serving
     scheduler feeds it each decode wave's wall time
     (``RalmScheduler._record_wave``), the controller each train step's.
  3. A run resumes on another number of ranks: checkpoints hold whole
     leaves, and ``elastic_restore`` places them on the live rank's
     device (no sharded leaves until the sharding rules are ported).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib

__all__ = ["StragglerEvent", "StragglerMonitor", "SimulatedFailure",
           "TrainController", "elastic_restore"]


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


class SimulatedFailure(RuntimeError):
    pass


class TrainController:
    """Drives ``train_step`` with periodic async checkpoints and crash
    recovery.

    ``run`` executes steps [resume_step, total). A registered failure
    step (``fail_at``) raises ``SimulatedFailure`` after that step has
    run and its checkpoint (if one is due) is written, emulating a node
    loss; calling ``run`` again resumes from the newest complete
    checkpoint with the same data order. Each step's batch goes to the
    parameters' device, and its metrics become floats after the step.
    With a data-parallel ``group`` (``launch.dp.Group``) rank r trains
    on ``host_batch(step, r, size)`` and only rank 0 writes checkpoints
    (every rank holds the same parameters)."""

    def __init__(self, train_step: Callable, data_source, ckpt_dir,
                 ckpt_every: int = 10,
                 monitor: Optional[StragglerMonitor] = None, group=None):
        self.train_step = train_step
        self.data = data_source
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.monitor = monitor or StragglerMonitor()
        self.saver = ckpt_lib.AsyncCheckpointer(ckpt_dir)
        self.group = group
        self.fail_at: Optional[int] = None
        self.metrics_log: List[Dict] = []

    def resume_or_init(self, params, opt_state):
        """The newest complete checkpoint's trees on the parameters'
        device (the run may have had another number of ranks), or the
        given trees at step 0."""
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        (params, opt_state), _ = ckpt_lib.restore(
            self.ckpt_dir, (params, opt_state), step=step,
            device=tree_lib.leaves(params)[0].device)
        return params, opt_state, step

    def run(self, params, opt_state, total_steps: int):
        params, opt_state, start = self.resume_or_init(params, opt_state)
        device = tree_lib.leaves(params)[0].device
        rank, size = ((0, 1) if self.group is None
                      else (self.group.rank, self.group.size))
        for step in range(start, total_steps):
            t0 = time.time()
            batch = self.data.host_batch(step, rank, size)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items()}
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = step
            self.metrics_log.append(metrics)
            self.monitor.record(step, time.time() - t0)
            done = step + 1
            if rank == 0 and (done % self.ckpt_every == 0
                              or done == total_steps):
                self.saver.save(done, (params, opt_state))
            if self.fail_at is not None and done == self.fail_at:
                self.fail_at = None
                self.saver.wait()
                raise SimulatedFailure(f"injected node failure at step {done}")
        self.saver.wait()
        return params, opt_state


def elastic_restore(ckpt_dir, like: Any, world, step: Optional[int] = None):
    """Resume a checkpoint on another number of ranks: whole leaves onto
    the live rank's device (``world.device``). Returns (tree, step)."""
    return ckpt_lib.restore(ckpt_dir, like, step=step, device=world.device)
