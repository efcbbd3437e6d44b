"""The retrieval tier: the batching service, the K-selection merge, the
stage counters."""
from repro_torch.retrieval.service import (LocalPipeline, RetrievalService,
                                           SearchHandle, ServiceConfig)
from repro_torch.retrieval.stats import RetrievalStats

__all__ = ["LocalPipeline", "RetrievalService", "RetrievalStats",
           "SearchHandle", "ServiceConfig"]
