"""``DatastoreBuilder`` — the one place an IVF-PQ datastore is built
(twin of ``repro.serve.datastore``).

  * ``build(vectors, ...)`` indexes an explicit vector set;
  * ``from_corpus(params, cfg, corpus)`` builds the kNN-LM datastore:
    the LM's own hidden state at every prefix of a token corpus, each
    keyed to the next token (paper §2.1).

The builder runs on the GPU unless ``device`` names another device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.ivfpq import (IVFPQConfig, IVFPQParams, IVFPQShard,
                                    assign_coarse, build_shards, train_ivfpq)
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.retrieval.service import RetrievalService, ServiceConfig
from repro_torch.serve.api import AsyncRetriever, LocalRetriever


@dataclasses.dataclass
class Datastore:
    """A built index + its payload table."""
    params: IVFPQParams
    shards: List[IVFPQShard]
    index_cfg: IVFPQConfig
    payload_tokens: Optional[torch.Tensor] = None   # [N] next-token table
    num_vectors: int = 0

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def to(self, device) -> "Datastore":
        return Datastore(
            params=IVFPQParams(*(t.to(device) for t in self.params)),
            shards=[IVFPQShard(*(t.to(device) for t in s))
                    for s in self.shards],
            index_cfg=self.index_cfg,
            payload_tokens=None if self.payload_tokens is None
            else self.payload_tokens.to(device),
            num_vectors=self.num_vectors)

    def search_config(self, nprobe: int = 32, k: int = 100, **kw
                      ) -> ChamVSConfig:
        return ChamVSConfig(ivfpq=self.index_cfg, nprobe=nprobe, k=k, **kw)

    def retriever(self, search_cfg: ChamVSConfig,
                  query_proj: Optional[torch.Tensor] = None
                  ) -> LocalRetriever:
        """Single-process ``Retriever`` over this datastore."""
        return LocalRetriever(params=self.params, shards=self.shards,
                              cfg=search_cfg,
                              payload_tokens=self.payload_tokens,
                              query_proj=query_proj)

    def async_retriever(self, search_cfg: ChamVSConfig,
                        query_proj: Optional[torch.Tensor] = None,
                        service_cfg: Optional[ServiceConfig] = None
                        ) -> AsyncRetriever:
        """Service-backed ``Retriever``: a wave's queries coalesce into one
        batched search."""
        service = RetrievalService.local(self.params, self.shards,
                                         search_cfg, config=service_cfg)
        return AsyncRetriever(service=service,
                              payload_tokens=self.payload_tokens,
                              query_proj=query_proj)


@dataclasses.dataclass
class DatastoreBuilder:
    """Hyperparameters of the build (the reference's defaults).
    ``m=None`` derives the PQ sub-quantizer count as ``dim // 16`` (at
    least 4). ``list_cap=None`` fits the list capacity to the largest
    per-shard list slice, rounded up to 128."""
    dim: int
    nlist: int = 8
    m: Optional[int] = None
    list_cap: Optional[int] = 1024
    residual: bool = False
    num_shards: int = 2
    kmeans_iters: int = 8
    seed: int = 1
    device: Optional[str] = None         # None = the GPU

    def index_config(self) -> IVFPQConfig:
        m = self.m if self.m is not None else max(self.dim // 16, 4)
        return IVFPQConfig(dim=self.dim, nlist=self.nlist, m=m,
                           list_cap=self.list_cap or 128,
                           residual=self.residual)

    def _fit_list_cap(self, params: IVFPQParams, vectors: torch.Tensor
                      ) -> int:
        counts = torch.bincount(assign_coarse(params, vectors),
                                minlength=self.nlist)
        per_shard = -(-int(counts.max()) // self.num_shards)
        return max(128, -(-per_shard // 128) * 128)

    def build(self, vectors, payload_tokens=None,
              train_vectors=None) -> Datastore:
        """Train the quantizers (on ``train_vectors`` if given, else on
        the full set) and stripe every IVF list over ``num_shards``
        memory nodes (partition scheme 1)."""
        dev = device_lib.resolve(self.device)
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
        train = vectors if train_vectors is None else torch.as_tensor(
            train_vectors, dtype=torch.float32).to(dev)
        icfg = self.index_config()
        gen = torch.Generator().manual_seed(self.seed)
        params = train_ivfpq(gen, train, icfg,
                             kmeans_iters=self.kmeans_iters)
        if self.list_cap is None:
            icfg = dataclasses.replace(
                icfg, list_cap=self._fit_list_cap(params, vectors))
        shards = build_shards(params, vectors, icfg,
                              num_shards=self.num_shards)
        return Datastore(
            params=params, shards=shards, index_cfg=icfg,
            payload_tokens=None if payload_tokens is None
            else torch.as_tensor(payload_tokens).to(dev, torch.int32),
            num_vectors=vectors.shape[0])

    @staticmethod
    def corpus_keys(params, cfg: ModelConfig, corpus: np.ndarray,
                    batch: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
        """kNN-LM keys: the LM's hidden state at every prefix of
        ``corpus`` [n_docs, doc_len], paired with the next token, on the
        params' device: (keys [N, d_model] f32, next_tokens [N] int32).
        The forward runs ``batch`` documents at a time."""
        dev = params["embed"].device
        corpus = torch.as_tensor(np.asarray(corpus, np.int32)).to(dev)
        keys = []
        with torch.no_grad():
            for s in range(0, corpus.shape[0], batch):
                h = tf.hidden_states(params, cfg, corpus[s:s + batch])
                keys.append(h[:, :-1].float().reshape(-1, cfg.d_model))
        return torch.cat(keys), corpus[:, 1:].reshape(-1)

    def from_corpus(self, params, cfg: ModelConfig, corpus: np.ndarray
                    ) -> Datastore:
        """Build the kNN-LM datastore from the model's own hidden states
        over ``corpus``."""
        if self.dim != cfg.d_model:
            raise ValueError(f"builder dim {self.dim} != d_model "
                             f"{cfg.d_model}")
        keys, nxt = self.corpus_keys(params, cfg, corpus)
        return self.build(keys, payload_tokens=nxt)
