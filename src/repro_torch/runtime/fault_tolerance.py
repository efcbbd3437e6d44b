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
  3. A run resumes on another number of ranks or another mesh:
     checkpoints hold whole leaves in the reference's layout (a sharded
     run gathers them first), and ``elastic_restore`` places them on the
     live rank's device, and onto its mesh position with ``put_named``
     when the rank is one of a sharded mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.models.sharding import put_named

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
    With a ``group`` (``launch.dp.Group``) a rank trains on
    ``host_batch(step, d, D)``, d its data coordinate of D: the ranks of
    one data row read one batch. A sharded step (``train_step.layout``)
    gets this rank's shards of the whole trees ``run`` is given or
    restores, and at a checkpoint every rank joins the gather of whole
    leaves; only rank 0 writes checkpoints."""

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
        device (the run may have had another number of ranks or another
        mesh), or the given whole trees at step 0; under a sharded step
        (``train_step.layout``) this rank's shards of them."""
        layout = getattr(self.train_step, "layout", None)
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            if layout is not None:
                params, opt_state = layout.put((params, opt_state))
            return params, opt_state, 0
        if layout is not None:
            (params, opt_state), _ = elastic_restore(
                self.ckpt_dir, (params, opt_state), layout.group, step,
                specs=layout.state_specs)
            return params, opt_state, step
        (params, opt_state), _ = ckpt_lib.restore(
            self.ckpt_dir, (params, opt_state), step=step,
            device=tree_lib.leaves(params)[0].device)
        return params, opt_state, step

    def run(self, params, opt_state, total_steps: int):
        """Steps [resume step, ``total_steps``) from whole trees (the
        given ones, or the newest checkpoint's); returns this rank's
        trees (its shards under a sharded step)."""
        params, opt_state, start = self.resume_or_init(params, opt_state)
        layout = getattr(self.train_step, "layout", None)
        device = tree_lib.leaves(params)[0].device
        rank, row, rows = 0, 0, 1
        if self.group is not None:
            rank, row = self.group.rank, self.group.coords["data"]
            rows = self.group.shape["data"]
        for step in range(start, total_steps):
            t0 = time.time()
            batch = self.data.host_batch(step, row, rows)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items()}
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = step
            self.metrics_log.append(metrics)
            self.monitor.record(step, time.time() - t0)
            done = step + 1
            if done % self.ckpt_every == 0 or done == total_steps:
                state = (params, opt_state) if layout is None \
                    else layout.gather((params, opt_state))
                if rank == 0:
                    self.saver.save(done, state)
                del state
            if self.fail_at is not None and done == self.fail_at:
                self.fail_at = None
                self.saver.wait()
                raise SimulatedFailure(f"injected node failure at step {done}")
        self.saver.wait()
        return params, opt_state


def elastic_restore(ckpt_dir, like: Any, world, step: Optional[int] = None,
                    specs: Any = None):
    """Resume a checkpoint on another number of ranks or another mesh:
    whole leaves onto the live rank's device (``world.device``), then,
    given the tree's ``specs`` on a rank of a mesh of more than one
    (``launch.dp.Group``), the rank's shards (``put_named``). ``like``:
    whole leaves, or anything with their shapes. Returns (tree, step)."""
    tree, step = ckpt_lib.restore(ckpt_dir, like, step=step,
                                  device=world.device)
    if specs is not None and world.size > 1:
        tree = put_named(tree, specs, world.mesh, world)
    return tree, step
