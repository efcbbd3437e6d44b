"""Adapters: absorb the port's stats objects into one ``MetricsRegistry``
(twin of ``repro.obs.adapters``, engine side).

The serving stack already counts almost everything — ``PoolStats`` on
the KV pool, ``RetrievalStats`` on the service, the straggler count on
the scheduler — each with its own shape. Rather than re-instrumenting those hot paths, these adapters
register *collectors*: zero-arg callables the registry runs at scrape
time that copy the live values into named Prometheus families. Cost is
paid per scrape, not per token.

Family naming follows the reference: everything is prefixed ``ralm_``,
counter families end in ``_total``, breakdowns use labels. The
reference's ``ralm_kernel_fallbacks_total`` (Pallas-to-ref routing
decisions) has no counterpart, because the port never falls back: a
CUDA tensor launches its kernel or raises.
"""
from __future__ import annotations

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["bind_engine_metrics"]

_STAGES = ("queue_wait", "scan", "merge", "gather")


def bind_engine_metrics(registry: MetricsRegistry, engine) -> None:
    """Register collectors for everything an ``RalmEngine`` owns: KV
    pool, retrieval service, scheduler. Idempotent
    metric creation; call once per (registry, engine) pair."""
    kv_slots = registry.gauge(
        "ralm_kv_slots", "KV-pool slot rows by state")
    kv_allocs = registry.counter(
        "ralm_kv_allocs_total", "KV-pool slot rows handed out")
    kv_releases = registry.counter(
        "ralm_kv_releases_total", "KV-pool slot rows returned")
    kv_high_water = registry.gauge(
        "ralm_kv_high_water", "max KV slot rows in use at once")
    kv_waves = registry.counter(
        "ralm_kv_waves_total", "decode waves dispatched")
    kv_compiles = registry.gauge(
        "ralm_kv_decode_compiles",
        "distinct decode-wave shapes (bucket, kv_len, capacity, max_seq)")
    kv_skip = registry.gauge(
        "ralm_kv_attn_skip_fraction",
        "fraction of pool seq blocks cropped by length-aware attention")
    ret_queries = registry.counter(
        "ralm_retrieval_queries_total", "query rows submitted")
    ret_batches = registry.counter(
        "ralm_retrieval_batches_total", "retrieval flushes (batched "
        "scan+merge dispatches)")
    ret_dispatches = registry.counter(
        "ralm_retrieval_scan_dispatches_total",
        "ChamVS scan kernel dispatches")
    ret_cache = registry.counter(
        "ralm_retrieval_cache_total", "query rows by cache result")
    ret_coalesce = registry.gauge(
        "ralm_retrieval_coalescing_factor", "query rows per dispatch")
    ret_qps = registry.gauge(
        "ralm_retrieval_qps", "query rate over the active window")
    ret_stage = registry.gauge(
        "ralm_retrieval_stage_seconds",
        "per-stage latency summary (mean/max/p50/p99), seconds")
    spec_issued = registry.counter(
        "ralm_spec_issued_total",
        "speculative retrievals issued (due steps that decoded ahead "
        "on stale neighbors)")
    spec_verified = registry.counter(
        "ralm_spec_verified_total",
        "speculation points verified, by outcome")
    spec_landed = registry.counter(
        "ralm_spec_landed_total",
        "speculation points whose search results had already "
        "materialized at harvest (latency fully hidden behind decode)")
    spec_discarded = registry.counter(
        "ralm_spec_discarded_total",
        "speculation points dropped unverified (rollback cascade / "
        "cancel / flush)")
    spec_replayed = registry.counter(
        "ralm_spec_replayed_steps_total",
        "decode steps redone during rollback replay")
    spec_accept = registry.gauge(
        "ralm_spec_acceptance_rate",
        "fraction of verified speculation points whose token matched")
    spec_stage = registry.gauge(
        "ralm_spec_stage_seconds",
        "speculation stage latency summary (spec_wait = residual "
        "retrieval block, spec_replay = rollback cost), seconds")
    fault_total = registry.counter(
        "ralm_retrieval_fault_total",
        "fault-tolerant dispatch events by kind (timeout/hedge/retry/"
        "crash/ejection/recovery/partial_flush/partial_row/spec_flushed)")
    fault_dispatch = registry.gauge(
        "ralm_retrieval_fault_dispatch_seconds",
        "fault-tolerant dispatch loop wall time per flush "
        "(scan + failover + hedging), summary stats in seconds")
    fault_replicas = registry.gauge(
        "ralm_retrieval_fault_replicas",
        "retrieval dispatch replicas by health state")
    straggler_waves = registry.counter(
        "ralm_wave_straggler_total",
        "decode waves flagged as stragglers (>threshold x rolling "
        "median wave time)")

    def collect() -> None:
        pool = engine.pool
        if pool is not None:
            ps = pool.stats
            kv_slots.set(pool.num_used, labels={"state": "used"})
            kv_slots.set(pool.num_free, labels={"state": "free"})
            kv_allocs.set_total(ps.allocs)
            kv_releases.set_total(ps.releases)
            kv_high_water.set(ps.high_water)
            kv_waves.set_total(ps.waves)
            kv_compiles.set(ps.decode_compiles)
            kv_skip.set(ps.skip_fraction())
        service = getattr(engine.retriever, "service", None)
        if service is not None:
            st = service.stats
            ret_queries.set_total(st.num_queries)
            ret_batches.set_total(st.num_batches)
            ret_dispatches.set_total(st.scan_dispatches)
            ret_cache.set_total(st.cache_hits, labels={"result": "hit"})
            ret_cache.set_total(st.cache_misses,
                                labels={"result": "miss"})
            ret_cache.set_total(st.cache_stale,
                                labels={"result": "stale"})
            ret_coalesce.set(st.coalescing_factor())
            ret_qps.set(st.qps())
            for stage in _STAGES:
                stat = getattr(st, stage)
                ret_stage.set(stat.mean_s,
                              labels={"stage": stage, "stat": "mean"})
                ret_stage.set(stat.max_s,
                              labels={"stage": stage, "stat": "max"})
                ret_stage.set(stat.p50_s(),
                              labels={"stage": stage, "stat": "p50"})
                ret_stage.set(stat.p99_s(),
                              labels={"stage": stage, "stat": "p99"})
            spec_issued.set_total(st.spec_issued)
            spec_verified.set_total(st.spec_accepted,
                                    labels={"outcome": "accepted"})
            spec_verified.set_total(st.spec_rollbacks,
                                    labels={"outcome": "rollback"})
            spec_landed.set_total(st.spec_landed)
            spec_discarded.set_total(st.spec_discarded)
            spec_replayed.set_total(st.spec_replayed_steps)
            spec_accept.set(st.spec_acceptance_rate())
            for stage in ("spec_wait", "spec_replay"):
                stat = getattr(st, stage)
                spec_stage.set(stat.mean_s,
                               labels={"stage": stage, "stat": "mean"})
                spec_stage.set(stat.p99_s(),
                               labels={"stage": stage, "stat": "p99"})
            for kind, val in (("timeout", st.ft_timeouts),
                              ("hedge", st.ft_hedges),
                              ("retry", st.ft_retries),
                              ("crash", st.ft_crashes),
                              ("ejection", st.ft_ejections),
                              ("recovery", st.ft_recoveries),
                              ("partial_flush", st.ft_partial_flushes),
                              ("partial_row", st.ft_partial_rows),
                              ("spec_flushed", st.ft_spec_flushed)):
                fault_total.set_total(val, labels={"kind": kind})
            fault_dispatch.set(st.ft_dispatch.mean_s,
                               labels={"stat": "mean"})
            fault_dispatch.set(st.ft_dispatch.p99_s(),
                               labels={"stat": "p99"})
            replicas = service.replicas
            if replicas is not None:
                for state, n in replicas.state_counts().items():
                    fault_replicas.set(n, labels={"state": state})
        straggler_waves.set_total(engine.scheduler.straggler_events)

    registry.register_collector(collect)
