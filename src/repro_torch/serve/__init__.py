"""``repro_torch.serve`` — the RALM serving API on PyTorch::

    from repro_torch.serve import DatastoreBuilder, EngineConfig, RalmEngine

    ds = DatastoreBuilder(dim=cfg.d_model).from_corpus(params, cfg, corpus)
    engine = RalmEngine.from_config(EngineConfig(cfg, rag), params, ds,
                                    ds.search_config(k=rag.k))
    tokens = engine.generate(prompt, steps=8)

The HTTP front door is ``Gateway`` (``repro_torch.serve.gateway``).
``EngineConfig(disaggregate=True)`` serves from an LM pool (this process)
and a retrieval pool of memory-node processes (``DisaggregatedBackend``,
``DistributedRetriever``, ``PoolTimes``); close such an engine.
"""
from repro_torch.core.rag import RagConfig
from repro_torch.retrieval.service import (RetrievalService, SearchHandle,
                                           ServiceConfig)
from repro_torch.serve.api import (AsyncRetriever, DistributedRetriever,
                                   EngineConfig, LocalRetriever, RalmRequest,
                                   RalmResponse, Retriever)
from repro_torch.serve.datastore import Datastore, DatastoreBuilder
from repro_torch.serve.engine import (DisaggregatedBackend,
                                      MonolithicBackend, PoolTimes,
                                      RalmEngine, SequenceState, SpecPoint)
from repro_torch.serve.gateway import (AdmissionController, DegradeConfig,
                                       DegradePolicy, Gateway, GatewayConfig,
                                       TenantQuota)
from repro_torch.serve.kvpool import KVCachePool, PoolStats
from repro_torch.serve.scheduler import RalmScheduler

__all__ = [
    "AdmissionController", "AsyncRetriever", "Datastore",
    "DatastoreBuilder", "DegradeConfig", "DegradePolicy",
    "DisaggregatedBackend", "DistributedRetriever", "EngineConfig",
    "Gateway", "GatewayConfig", "KVCachePool", "LocalRetriever",
    "MonolithicBackend", "PoolStats", "PoolTimes", "RagConfig", "RalmEngine",
    "RalmRequest", "RalmResponse", "RalmScheduler", "RetrievalService",
    "Retriever", "SearchHandle", "SequenceState", "ServiceConfig",
    "SpecPoint", "TenantQuota",
]
