"""The retrieval tier (twin of ``repro.retrieval``, local pipeline):

  * ``merge``   — per-shard top-k' -> global top-K K-selection (flat or
    hierarchical, exact at every level), and ``mask_producers`` for
    partial results;
  * ``cache``   — LRU query-result cache on quantized query vectors;
  * ``stats``   — per-stage latency / QPS / coalescing / fault accounting;
  * ``replica`` — per-shard replica groups + the health state machine
    behind fault-tolerant dispatch (failover, hedging, ejection);
  * ``chaos``   — deterministic fault injection (``FaultPlan``) at the
    pipeline scan boundary;
  * ``service`` — ``RetrievalService``: in-flight request table,
    deadline-based micro-batching, ``SearchHandle`` futures,
    fault-tolerant dispatch with partial-result degradation.
"""
from repro_torch.retrieval.cache import QueryCache
from repro_torch.retrieval.chaos import (ChaosInjector, FaultPlan, FaultSpec,
                                         ReplicaCrash, ScanHang,
                                         TransientScanError, crash_plan)
from repro_torch.retrieval.merge import (flat_merge, hierarchical_merge,
                                         mask_producers, merge_topk)
from repro_torch.retrieval.replica import FailoverConfig, ReplicaGroup
from repro_torch.retrieval.service import (LocalPipeline, RetrievalService,
                                           SearchHandle, ServiceConfig)
from repro_torch.retrieval.stats import RetrievalStats, StageStat

__all__ = [
    "ChaosInjector", "FailoverConfig", "FaultPlan", "FaultSpec",
    "LocalPipeline", "QueryCache", "ReplicaCrash", "ReplicaGroup",
    "RetrievalService", "RetrievalStats", "ScanHang", "SearchHandle",
    "ServiceConfig", "StageStat", "TransientScanError", "crash_plan",
    "flat_merge", "hierarchical_merge", "mask_producers", "merge_topk",
]
