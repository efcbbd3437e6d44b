"""The RALM serving surface (twin of ``repro.serve.api``): requests,
responses, the engine config, and the ``Retriever`` protocol with its
local and service-backed implementations.

``EngineConfig`` keeps the reference's field names for the fields this
slice implements. It has no kernel-selection knobs: the device decides
(kernels on the GPU, plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core import rag as rag_lib
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.ivfpq import IVFPQParams, IVFPQShard
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig
from repro_torch.retrieval.service import (RetrievalService, SearchHandle,
                                           ServiceConfig, sync)


@dataclasses.dataclass
class RequestTiming:
    """Wall-clock milestones of one request (``time.perf_counter()``)."""
    arrival: Optional[float] = None
    admit: Optional[float] = None
    first_token: Optional[float] = None
    finish: Optional[float] = None


@dataclasses.dataclass
class RalmRequest:
    """One serving request: a prompt batch [B, T0] decoded in lockstep.

    ``rng`` (a ``torch.Generator``) samples when ``greedy`` is False;
    ``trace`` collects per-step dicts of retrieved ids."""
    prompt: torch.Tensor                 # [B, T0] integer tokens
    steps: int
    greedy: bool = True
    rng: Optional[torch.Generator] = None
    trace: Optional[list] = None
    request_id: Optional[int] = None     # assigned at submit()
    times: RequestTiming = dataclasses.field(default_factory=RequestTiming)


@dataclasses.dataclass
class RalmResponse:
    request_id: int
    tokens: np.ndarray                   # [B, T0 + steps]
    steps: int
    trace: Optional[list] = None
    times: Optional[RequestTiming] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Deployment shape of one monolithic RALM engine."""
    model: ModelConfig
    rag: RagConfig
    max_seq: Optional[int] = None        # KV budget; default T0 + steps
    max_active: Optional[int] = None     # scheduler admission limit
    async_retrieval: bool = False        # route search through a
    #                                      RetrievalService (AsyncRetriever)
    retrieval_measure: bool = True       # per-stage service timings (a
    #                                      device sync per stage)
    kv_slots: Optional[int] = None       # KV pool capacity in prompt rows;
    #                                      None = grow on demand
    attn_seq_block: int = 16             # KV-pool seq-axis alignment:
    #                                      per-wave attention reads crop
    #                                      to this quantum (kv_len)


@runtime_checkable
class Retriever(Protocol):
    """What the engine needs from a retrieval service."""

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, d] queries -> (dists [B, K], global ids [B, K])."""
        ...

    def resolve(self, ids: torch.Tensor, kind: str = "tokens"
                ) -> torch.Tensor:
        """[B, K] ids -> next tokens [B, K], -1 where the id is -1."""
        ...


def _resolve_tokens(payload_tokens: Optional[torch.Tensor], ids: torch.Tensor,
                    kind: str) -> torch.Tensor:
    if kind != "tokens":
        raise ValueError(f"unsupported payload kind: {kind!r}")
    if payload_tokens is None:
        raise ValueError("retriever has no payload_tokens table")
    toks = rag_lib.gather_payload(payload_tokens, ids)
    return torch.where(ids >= 0, toks, torch.full_like(toks, -1))


def _project(queries: torch.Tensor, query_proj: Optional[torch.Tensor]
             ) -> torch.Tensor:
    q = queries.float()
    return q if query_proj is None else q @ query_proj


@dataclasses.dataclass
class LocalRetriever:
    """Single-process ChamVS over a list of shards. Searches go through a
    private ``RetrievalService`` (no timing syncs, no pow2 padding), so
    there is one search implementation."""
    params: IVFPQParams
    shards: List[IVFPQShard]
    cfg: ChamVSConfig
    payload_tokens: Optional[torch.Tensor] = None   # [N] next-token table
    query_proj: Optional[torch.Tensor] = None       # [d_model, dq]

    def __post_init__(self):
        self.service = RetrievalService.local(
            self.params, self.shards, self.cfg,
            ServiceConfig(measure=False, bucket_pow2=False))

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.service.search(_project(queries, self.query_proj))

    def resolve(self, ids: torch.Tensor, kind: str = "tokens"
                ) -> torch.Tensor:
        return _resolve_tokens(self.payload_tokens, ids, kind)


@dataclasses.dataclass
class AsyncRetriever:
    """``Retriever`` backed by a ``RetrievalService``: ``search_async``
    enqueues, ``flush`` runs every queued query of a wave as one batch."""
    service: RetrievalService
    payload_tokens: Optional[torch.Tensor] = None
    query_proj: Optional[torch.Tensor] = None

    def search_async(self, queries: torch.Tensor) -> SearchHandle:
        return self.service.submit(_project(queries, self.query_proj))

    def flush(self) -> None:
        self.service.flush()

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.search_async(queries).result()

    def resolve(self, ids: torch.Tensor, kind: str = "tokens"
                ) -> torch.Tensor:
        if not self.service.config.measure:
            return _resolve_tokens(self.payload_tokens, ids, kind)
        t0 = time.perf_counter()
        out = _resolve_tokens(self.payload_tokens, ids, kind)
        sync(out)
        self.service.stats.gather.add(time.perf_counter() - t0)
        return out
