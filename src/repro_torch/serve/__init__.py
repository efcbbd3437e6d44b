"""``repro_torch.serve`` — the RALM serving API on PyTorch::

    from repro_torch.serve import DatastoreBuilder, EngineConfig, RalmEngine

    ds = DatastoreBuilder(dim=cfg.d_model).from_corpus(params, cfg, corpus)
    engine = RalmEngine.from_config(EngineConfig(cfg, rag), params, ds,
                                    ds.search_config(k=rag.k))
    tokens = engine.generate(prompt, steps=8)
"""
from repro_torch.core.rag import RagConfig
from repro_torch.retrieval.service import (RetrievalService, SearchHandle,
                                           ServiceConfig)
from repro_torch.serve.api import (AsyncRetriever, EngineConfig,
                                   LocalRetriever, RalmRequest, RalmResponse,
                                   Retriever)
from repro_torch.serve.datastore import Datastore, DatastoreBuilder
from repro_torch.serve.engine import (MonolithicBackend, RalmEngine,
                                      SequenceState, SpecPoint)
from repro_torch.serve.kvpool import KVCachePool, PoolStats
from repro_torch.serve.scheduler import RalmScheduler

__all__ = [
    "AsyncRetriever", "Datastore", "DatastoreBuilder", "EngineConfig",
    "KVCachePool", "LocalRetriever", "MonolithicBackend", "PoolStats",
    "RagConfig", "RalmEngine", "RalmRequest", "RalmResponse",
    "RalmScheduler", "RetrievalService", "Retriever", "SearchHandle",
    "SequenceState", "ServiceConfig", "SpecPoint",
]
