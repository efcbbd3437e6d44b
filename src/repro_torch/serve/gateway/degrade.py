"""Graceful degradation: trade retrieval quality for serving capacity
(twin of ``repro.serve.gateway.degrade``).

VectorLiteRAG (arXiv 2504.08930) makes the observation this module
encodes: when a RAG system saturates, the right first knob is not the
LM — it is retrieval *quality*. Scanning fewer IVF lists (``nprobe``)
cuts search cost almost linearly with a gentle recall slope, widening
the retrieval interval amortizes the search over more tokens, and in
extremis running the LM bare (kNN-off) sheds the whole retrieval tier.
All three preserve liveness: every admitted request still completes,
just with degraded augmentation — strictly better under overload than
unbounded queueing (RAGO's tail-latency lens) or hard-rejecting
already-admitted work.

``DegradePolicy`` owns a ladder of levels built from the engine's
baseline config:

    level 0   baseline                       (nprobe0, interval0, kNN on)
    level 1.. nprobe0/2, /4, ... min_nprobe  (cheaper scans)
    level  +1 interval0 * interval_factor    (retrieve less often)
    level  +1 partial-retrieval              (serve the live fault-domain
                                              subset, no hedges/retries —
                                              only with a fault-tolerant
                                              RetrievalService)
    level  +1 kNN off                        (rag.mode = "none")

The step loop calls ``observe(queue_depth)`` once per wave; sustained
pressure (``patience`` consecutive ticks above ``high_watermark``)
steps DOWN one level, sustained calm (``recovery`` ticks at or below
``low_watermark``) steps back UP one level. Hysteresis is deliberate:
the two watermarks plus the tick counts keep the policy from
oscillating on a bursty queue. Every transition is counted and
timestamped for /statsz and the load harness.

Applying a level mutates the live engine between waves (the policy
runs on the scheduler thread, so there is no race with a wave in
flight):

  * ``rag.interval`` / ``rag.mode`` — ``engine.rag`` is replaced
    (host-side arithmetic in ``_retrieval_due``; next wave sees it);
  * ``nprobe`` — the retriever pipeline's ``ChamVSConfig`` is replaced
    (the next flush's IVF probe and scan launch at the new nprobe;
    nothing is compiled per level, and the pipeline's k' does not depend
    on nprobe), after in-flight speculation is force-verified, and the
    service's result cache is marked stale (cached results were produced
    at another quality level; they stay usable as speculation seeds).

Degradation is *system-wide and between-wave* by construction: all
rows of a wave share one coalesced scan dispatch, so quality is a
property of the wave, not the request. Requests served entirely inside
one level are greedy-reproducible in-process by pinning that level's
(nprobe, interval, mode) — the load harness exploits exactly that for
its parity check.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class DegradeLevel:
    """One rung: the complete retrieval-quality setting at this level."""
    name: str
    nprobe: int
    interval: int
    knn: bool                     # False = retrieval fully off
    partial: bool = False         # "partial-retrieval" rung: the
    #                               fault-tolerant dispatch gives every
    #                               domain ONE attempt and serves the
    #                               live subset — no hedges, retries, or
    #                               tail waits (needs service.replicas)

    def as_dict(self) -> Dict[str, object]:
        return dict(name=self.name, nprobe=self.nprobe,
                    interval=self.interval, knn=self.knn,
                    partial=self.partial)


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Ladder + hysteresis knobs."""
    high_watermark: int = 8       # queue depth that counts as pressure
    low_watermark: int = 1        # depth that counts as recovered
    patience: int = 3             # pressured ticks before stepping down
    recovery: int = 20            # calm ticks before stepping back up
    min_nprobe: int = 1           # floor of the nprobe rungs
    interval_factor: int = 4      # widen rag.interval by this much
    partial_rung: bool = True     # include the partial-retrieval rung
    #                               (skipped when the engine's service
    #                               has no fault-tolerant dispatch layer)
    knn_off_rung: bool = True     # include the final retrieval-off rung


class DegradePolicy:
    """Watches queue depth, walks the ladder, mutates the engine."""

    def __init__(self, engine, config: Optional[DegradeConfig] = None):
        self.engine = engine
        self.config = config or DegradeConfig()
        self._base_mode = engine.rag.mode   # restored on full recovery
        self.ladder = self._build_ladder()
        self.level = 0
        self._pressure_ticks = 0
        self._calm_ticks = 0
        # observability: every transition, plus aggregate counters
        self.transitions_down = 0
        self.transitions_up = 0
        self.ticks_at_level: List[int] = [0] * len(self.ladder)
        self.history: List[Dict[str, object]] = []

    # -- ladder construction ------------------------------------------------

    def _baseline(self) -> DegradeLevel:
        rag = self.engine.rag
        cfg = self._pipeline_cfg()
        return DegradeLevel(name="baseline",
                            nprobe=cfg.nprobe if cfg is not None else 0,
                            interval=max(1, rag.interval),
                            knn=rag.mode != "none")

    def _build_ladder(self) -> List[DegradeLevel]:
        base = self._baseline()
        ladder = [base]
        if not base.knn:              # engine already runs retrieval-free:
            return ladder             # nothing left to shed
        nprobe = base.nprobe
        while nprobe // 2 >= max(1, self.config.min_nprobe):
            nprobe //= 2
            ladder.append(DegradeLevel(
                name=f"nprobe/{base.nprobe // nprobe}", nprobe=nprobe,
                interval=base.interval, knn=True))
        widened = base.interval * self.config.interval_factor
        ladder.append(DegradeLevel(
            name=f"interval x{self.config.interval_factor}",
            nprobe=ladder[-1].nprobe, interval=widened, knn=True))
        if self.config.partial_rung and self._service_replicas():
            # cheaper than knn-off: keep retrieving, but serve whatever
            # fault domains answer on the first attempt (exact top-k
            # over the live subset) instead of hedging into the tail
            ladder.append(DegradeLevel(
                name="partial-retrieval", nprobe=ladder[-1].nprobe,
                interval=widened, knn=True, partial=True))
        if self.config.knn_off_rung:
            ladder.append(DegradeLevel(
                name="knn-off", nprobe=ladder[-1].nprobe,
                interval=widened, knn=False))
        return ladder

    # -- engine plumbing ----------------------------------------------------

    def _pipeline_cfg(self):
        """The live ``ChamVSConfig`` the searches run with, wherever the
        deployed retriever keeps it (service pipeline or local)."""
        ret = self.engine.retriever
        if ret is None:
            return None
        service = getattr(ret, "service", None)
        if service is not None:
            return service.pipeline.cfg
        return getattr(ret, "cfg", None)

    def _service(self):
        ret = self.engine.retriever
        return getattr(ret, "service", None) if ret is not None else None

    def _service_replicas(self) -> bool:
        """Whether the deployed service has the fault-tolerant dispatch
        layer (the partial-retrieval rung is meaningless without it)."""
        service = self._service()
        return service is not None and \
            getattr(service, "replicas", None) is not None

    def _set_nprobe(self, nprobe: int) -> None:
        ret = self.engine.retriever
        if ret is None or nprobe <= 0:
            return
        service = getattr(ret, "service", None)
        if service is not None:
            pipe = service.pipeline
            if pipe.cfg.nprobe != nprobe:
                pipe.cfg = dataclasses.replace(pipe.cfg, nprobe=nprobe)
                # cached neighbours were computed at another quality
                # level; serving them fresh would silently undo the
                # knob. A generation bump (not a drop) keeps them
                # available as stale speculation seeds, which
                # verification guards anyway.
                service.mark_cache_stale()
        if getattr(ret, "cfg", None) is not None and \
                ret.cfg.nprobe != nprobe:
            # a LocalRetriever searches through its private service
            # above; its own cfg follows so that it reads the same
            ret.cfg = dataclasses.replace(ret.cfg, nprobe=nprobe)

    def apply(self, level_idx: int) -> None:
        """Point the engine at ``ladder[level_idx]`` (idempotent)."""
        level = self.ladder[level_idx]
        # a knn rung restores the baseline mode a deeper rung turned off
        new_mode = self._base_mode if level.knn else "none"
        rag = self.engine.rag
        changed = (rag.interval != level.interval or rag.mode != new_mode)
        cfg = self._pipeline_cfg()
        changed = changed or (cfg is not None and level.nprobe > 0
                              and cfg.nprobe != level.nprobe)
        service = self._service()
        if service is not None and \
                getattr(service, "_degraded_partial", False) != level.partial:
            changed = True
        if changed:
            # in-flight speculation points were issued under the OLD
            # quality: force-verify them with the math they speculated
            # under before any knob moves (getattr: test stubs pass
            # bare engine doubles)
            flush = getattr(self.engine, "flush_speculation", None)
            if flush is not None:
                flush()
        if rag.interval != level.interval or rag.mode != new_mode:
            self.engine.rag = dataclasses.replace(
                rag, interval=level.interval, mode=new_mode)
        self._set_nprobe(level.nprobe)
        if service is not None:
            set_partial = getattr(service, "set_degraded_partial", None)
            if set_partial is not None:
                set_partial(level.partial)

    # -- the per-wave tick --------------------------------------------------

    def observe(self, queue_depth: int,
                now: Optional[float] = None) -> bool:
        """One tick: account pressure/calm, maybe transition. Returns
        True when the level changed (the caller may want to log)."""
        self.ticks_at_level[self.level] += 1
        changed = False
        if queue_depth > self.config.high_watermark:
            self._pressure_ticks += 1
            self._calm_ticks = 0
            if (self._pressure_ticks >= self.config.patience
                    and self.level + 1 < len(self.ladder)):
                self.level += 1
                self.transitions_down += 1
                self._pressure_ticks = 0
                changed = True
        elif queue_depth <= self.config.low_watermark:
            self._calm_ticks += 1
            self._pressure_ticks = 0
            if self._calm_ticks >= self.config.recovery and self.level > 0:
                self.level -= 1
                self.transitions_up += 1
                self._calm_ticks = 0
                changed = True
        else:
            self._pressure_ticks = 0
            self._calm_ticks = 0
        if changed:
            self.apply(self.level)
            self.history.append(dict(
                t=time.perf_counter() if now is None else now,
                level=self.level, name=self.ladder[self.level].name,
                queue_depth=queue_depth))
            # getattr: test stubs pass bare engine doubles with no tracer
            tracer = getattr(self.engine, "tracer", None)
            if tracer is not None and tracer.enabled:
                tracer.instant(
                    "degrade.transition", "gateway",
                    args=dict(level=self.level,
                              name=self.ladder[self.level].name,
                              queue_depth=queue_depth))
        return changed

    def stats(self) -> Dict[str, object]:
        return dict(
            level=self.level,
            level_name=self.ladder[self.level].name,
            ladder=[lv.as_dict() for lv in self.ladder],
            transitions_down=self.transitions_down,
            transitions_up=self.transitions_up,
            ticks_at_level=list(self.ticks_at_level),
        )
