"""Compatibility shim over ``repro_torch.serve`` (twin of
``repro.core.coordinator``, the old disaggregated entry point).

The paper's CPU coordinator with independent accelerator pools (§3)
lives in ``repro_torch.serve``:

  * pool split + timed decode  -> ``serve.engine.DisaggregatedBackend``
  * distributed search/gather  -> ``serve.api.DistributedRetriever``
  * the pipelined loop         -> ``serve.scheduler.RalmScheduler``
  * Fig. 13 ratio tracking     -> ``serve.engine.PoolTimes``

``DisaggregatedRuntime`` keeps the historical constructor and
``generate_pipelined`` surface on top of ``RalmEngine.disaggregated``:
the LM pool in this process, ``ret_devices`` memory-node processes. It
owns those processes: ``close()`` it (or use it as a context manager).
New code should build the engine directly.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.ivfpq import IVFPQParams, IVFPQShard
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import PoolTimes, RalmEngine

__all__ = ["DisaggregatedRuntime", "PoolTimes"]


class DisaggregatedRuntime:
    """Deprecated facade over ``RalmEngine.disaggregated``.

    ``lm_devices`` / ``ret_devices``: the pools' sizes (the LM pool is
    this process; the retrieval pool's axis is ("data",), one memory
    node per DB shard)."""

    def __init__(self, cfg: ModelConfig, rag: RagConfig, params,
                 db_params: IVFPQParams, db_shards: List[IVFPQShard],
                 chamvs_cfg: ChamVSConfig,
                 payload_tokens: Optional[torch.Tensor] = None,
                 lm_devices: int = 1, ret_devices: int = 1,
                 query_proj: Optional[torch.Tensor] = None):
        warnings.warn(
            "repro.core.coordinator.DisaggregatedRuntime is deprecated; "
            "use repro.serve.RalmEngine.disaggregated(...) or "
            "RalmEngine.from_config(...)", DeprecationWarning, stacklevel=2)
        self.cfg, self.rag = cfg, rag
        self.engine = RalmEngine.disaggregated(
            params, cfg, rag, db_params, db_shards, chamvs_cfg,
            payload_tokens=payload_tokens, lm_devices=lm_devices,
            ret_devices=ret_devices, query_proj=query_proj)

    @property
    def times(self) -> PoolTimes:
        return self.engine.times

    @property
    def lm_mesh(self):
        return self.engine.backend.lm_mesh

    @property
    def ret_mesh(self):
        return self.engine.backend.ret_mesh

    def search(self, queries: torch.Tensor):
        q = torch.as_tensor(queries, dtype=torch.float32)
        return self.engine._search(q.to(self.engine.backend.device))

    def decode(self, caches, token, position):
        return self.engine.backend.decode(caches, token, position)

    def generate_pipelined(self, prompts: List[torch.Tensor], steps: int
                           ) -> List[np.ndarray]:
        """Pipelined decode/search across request batches — the
        scheduler's two-phase step. Each entry of ``prompts`` is one
        batch [B, T0]."""
        return self.engine.generate_batches(prompts, steps)

    def close(self) -> None:
        """Stop the memory-node processes."""
        self.engine.close()

    def __enter__(self) -> "DisaggregatedRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
