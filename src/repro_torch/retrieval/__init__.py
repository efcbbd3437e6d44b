"""The retrieval tier: the batching service, the result cache, the
K-selection merge, the stage counters."""
from repro_torch.retrieval.cache import QueryCache
from repro_torch.retrieval.service import (LocalPipeline, RetrievalService,
                                           SearchHandle, ServiceConfig)
from repro_torch.retrieval.stats import RetrievalStats

__all__ = ["LocalPipeline", "QueryCache", "RetrievalService",
           "RetrievalStats", "SearchHandle", "ServiceConfig"]
