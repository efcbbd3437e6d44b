"""The RALM serving surface (twin of ``repro.serve.api``): requests,
responses, the engine config, and the ``Retriever`` protocol with its
local and service-backed implementations.

``EngineConfig`` keeps the reference's field names for the fields the
port implements. It has no kernel-selection knobs: the device decides
(kernels on the GPU, plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Callable, List, Optional, Protocol, Tuple,
                    runtime_checkable)

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
    """Wall-clock milestones of one request (``time.perf_counter()``):

      * ``arrival``     — entered the system (``submit()``, or earlier:
        the HTTP gateway stamps it at request parse, before admission);
      * ``admit``       — claimed KV slots and prefilled (``start``);
      * ``first_token`` — first generated token: on the host when the
        request streams (``on_token``), else when its wave was enqueued
        (TTFT = first_token - arrival);
      * ``finish``      — final token emitted (TPOT = (finish -
        first_token) / (steps - 1) for steps > 1).
    """
    arrival: Optional[float] = None
    admit: Optional[float] = None
    first_token: Optional[float] = None
    finish: Optional[float] = None

    def ttft_s(self) -> Optional[float]:
        if self.arrival is None or self.first_token is None:
            return None
        return self.first_token - self.arrival

    def tpot_s(self, steps: int) -> Optional[float]:
        if self.first_token is None or self.finish is None or steps < 2:
            return None
        return (self.finish - self.first_token) / (steps - 1)


@dataclasses.dataclass
class RalmRequest:
    """One serving request: a prompt batch [B, T0] decoded in lockstep.

    ``rng`` (a ``torch.Generator``) samples when ``greedy`` is False;
    ``trace`` collects per-step dicts of retrieved ids.

    ``tenant`` names the submitting client class for admission
    accounting; it never changes the math. ``on_token(step, tokens)`` is
    the streaming hook: called from the thread that runs the scheduler
    with the step's ``[B]`` tokens as a host int array, which costs one
    device sync a wave. ``cancelled`` aborts the request at the next
    scheduler step (``RalmScheduler.cancel`` sets it)."""
    prompt: torch.Tensor                 # [B, T0] integer tokens
    steps: int
    greedy: bool = True
    rng: Optional[torch.Generator] = None
    trace: Optional[list] = None
    request_id: Optional[int] = None     # assigned at submit()
    trace_id: Optional[int] = None       # observability flow id; defaults
    #                                      to request_id at submit()
    tenant: str = "default"
    on_token: Optional[Callable[[int, np.ndarray], None]] = None
    cancelled: bool = False
    times: RequestTiming = dataclasses.field(default_factory=RequestTiming)
    partial_steps: int = 0               # decode steps served from a
    #                                      partial retrieval result (a
    #                                      failed flush's sentinel)


@dataclasses.dataclass
class RalmResponse:
    request_id: int
    tokens: np.ndarray                   # [B, T0 + steps]
    steps: int
    trace: Optional[list] = None
    tenant: str = "default"
    cancelled: bool = False
    times: Optional[RequestTiming] = None
    partial_steps: int = 0               # steps decoded on partial
    #                                      retrieval results (0 = full
    #                                      quality throughout)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Deployment shape of one monolithic RALM engine."""
    model: ModelConfig
    rag: RagConfig
    max_seq: Optional[int] = None        # KV budget; default T0 + steps
    max_active: Optional[int] = None     # scheduler admission limit
    async_retrieval: bool = False        # route search through a
    #                                      RetrievalService (AsyncRetriever)
    retrieval_cache: int = 0             # service LRU cache entries (0=off)
    speculate_k: int = 0                 # speculative retrieval depth: max
    #                                      speculation points a sequence
    #                                      keeps outstanding (0 = off). A
    #                                      due row decodes ahead on its
    #                                      previous (stale) neighbors
    #                                      while the real search runs
    #                                      async; verification happens
    #                                      speculate_k waves later, off
    #                                      the critical path. Requires
    #                                      async_retrieval + wave_decode.
    speculate_verify: bool = True        # verify speculated tokens against
    #                                      the real neighbors and roll
    #                                      back on mismatch (greedy
    #                                      parity with speculation off).
    #                                      False trusts stale neighbors
    #                                      outright — bounded quality
    #                                      drift for zero rollback cost
    retrieval_measure: bool = True       # per-stage service timings (a
    #                                      device sync per stage)
    wave_decode: bool = True             # one decode per wave over a
    #                                      slotted KVCachePool; False keeps
    #                                      the per-sequence loop (one decode
    #                                      per request, private caches)
    kv_slots: Optional[int] = None       # KV pool capacity in prompt rows;
    #                                      None = grow on demand
    attn_seq_block: int = 16             # KV-pool seq-axis alignment:
    #                                      per-wave attention reads crop
    #                                      to this quantum (kv_len)
    trace: bool = False                  # enable the observability
    #                                      tracer (repro_torch.obs): spans
    #                                      across scheduler waves,
    #                                      retrieval stages and the KV
    #                                      pool (host wall time), exported
    #                                      as Chrome trace-event JSON
    trace_path: Optional[str] = None     # where RalmEngine.write_trace()
    #                                      saves the trace by default
    retrieval_deadline_s: float = 0.0    # per-dispatch retrieval latency
    #                                      budget: a fault domain still
    #                                      unresolved past it is dropped
    #                                      and the flush serves the exact
    #                                      top-k over the survivors
    #                                      (0 = wait indefinitely)
    hedge_quantile: float = 0.95         # latency quantile after which a
    #                                      hung dispatch is hedged to
    #                                      another replica
    shard_replicas: int = 1              # dispatch-target replicas per
    #                                      retrieval fault domain; > 1 (or
    #                                      a deadline/chaos plan) arms the
    #                                      fault-tolerant dispatch layer,
    #                                      which syncs every flush
    chaos_plan: Optional[str] = None     # path to a FaultPlan JSON to arm
    #                                      at the service's scan boundary
    #                                      (deterministic fault injection)


@runtime_checkable
class Retriever(Protocol):
    """What the engine needs from a retrieval service."""

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, d] queries -> (dists [B, K], global ids [B, K])."""
        ...

    def resolve(self, ids: torch.Tensor, kind: str = "tokens"
                ) -> torch.Tensor:
        """[B, K] ids -> next tokens [B, K] (kNN-LM), -1 where the id is
        -1, or chunks [B, K, chunk_len] (RETRO), PAD-0 rows there."""
        ...


def _resolve_from_tables(payload_tokens: Optional[torch.Tensor],
                         chunk_table: Optional[torch.Tensor],
                         ids: torch.Tensor, kind: str) -> torch.Tensor:
    """Gather from the table ``kind`` names and mask missing ids once."""
    if kind == "tokens":
        if payload_tokens is None:
            raise ValueError("retriever has no payload_tokens table")
        toks = rag_lib.gather_payload(payload_tokens, ids)
        return torch.where(ids >= 0, toks, torch.full_like(toks, -1))
    if kind == "chunks":
        if chunk_table is None:
            raise ValueError("retriever has no chunk_table")
        return rag_lib.retro_neighbor_tokens(chunk_table, ids)
    raise ValueError(f"unknown payload kind: {kind!r}")


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
    chunk_table: Optional[torch.Tensor] = None      # [N, chunk_len]

    def __post_init__(self):
        self.service = RetrievalService.local(
            self.params, self.shards, self.cfg,
            ServiceConfig(measure=False, bucket_pow2=False))

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.service.search(_project(queries, self.query_proj))

    def resolve(self, ids: torch.Tensor, kind: str = "tokens"
                ) -> torch.Tensor:
        return _resolve_from_tables(self.payload_tokens, self.chunk_table,
                                    ids, kind)


@dataclasses.dataclass
class AsyncRetriever:
    """``Retriever`` backed by a ``RetrievalService``: ``search_async``
    enqueues, ``flush`` runs every queued query of a wave as one batch,
    ``stale_lookup`` probes the service's cache for speculation seeds."""
    service: RetrievalService
    payload_tokens: Optional[torch.Tensor] = None
    query_proj: Optional[torch.Tensor] = None
    chunk_table: Optional[torch.Tensor] = None

    def search_async(self, queries: torch.Tensor) -> SearchHandle:
        return self.service.submit(_project(queries, self.query_proj))

    def stale_lookup(self, queries: torch.Tensor
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Any-generation cache probe: possibly stale neighbours to seed
        speculative decode (None on a miss or without a cache)."""
        return self.service.stale_lookup(_project(queries, self.query_proj))

    def flush(self) -> None:
        self.service.flush()

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.search_async(queries).result()

    def resolve(self, ids: torch.Tensor, kind: str = "tokens"
                ) -> torch.Tensor:
        if not self.service.config.measure:
            return _resolve_from_tables(self.payload_tokens,
                                        self.chunk_table, ids, kind)
        t0 = time.perf_counter()
        with self.service.tracer.span("retrieval.gather", "retrieval"):
            out = _resolve_from_tables(self.payload_tokens,
                                       self.chunk_table, ids, kind)
            sync(out)
        self.service.stats.gather.add(time.perf_counter() - t0)
        return out
