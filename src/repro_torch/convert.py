"""Carry the JAX package's weights and index into the port, leaf for leaf.

Inputs are numpy arrays only, so this module imports nothing of JAX:
callers turn each reference leaf into numpy first (``np.array(x)``
copies; a bfloat16 leaf crosses as float32, and casting it back to
``torch.bfloat16`` here is exact).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ivfpq import IVFPQConfig, IVFPQParams, IVFPQShard
from repro_torch.models.config import ModelConfig


def _tensor(a: np.ndarray, device, float_dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if float_dtype is not None and t.is_floating_point():
        t = t.to(float_dtype)
    return t.to(device)


def lm_params(tree: Mapping[str, Any], cfg: ModelConfig, device="cpu"
              ) -> Dict[str, Any]:
    """``repro.models.transformer.init_params`` layout (nested dicts of
    numpy leaves: ``classes``, and an encoder-decoder's ``encoder`` tree
    and cross-attention leaves) -> the port's params; float leaves take
    ``cfg.dtype``."""
    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(np.asarray(x), device, cfg.torch_dtype)
    return conv(tree)


def model_config(fields: Mapping[str, Any]) -> ModelConfig:
    """A reference ``ModelConfig``'s fields (``dataclasses.asdict``) ->
    the port's ``ModelConfig``."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in fields.items() if k in names})


def index_config(fields: Mapping[str, Any]) -> IVFPQConfig:
    """A reference ``IVFPQConfig``'s fields -> the port's."""
    return IVFPQConfig(**dict(fields))


def ivfpq_params(coarse_centroids: np.ndarray, codebooks: np.ndarray,
                 device="cpu") -> IVFPQParams:
    return IVFPQParams(
        coarse_centroids=_tensor(coarse_centroids, device, torch.float32),
        codebooks=_tensor(codebooks, device, torch.float32))


def ivfpq_shards(shards: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 device="cpu") -> List[IVFPQShard]:
    """[(codes [nlist, cap, m] uint8, ids [nlist, cap] int32,
    list_len [nlist] int32), ...] -> the port's shards."""
    return [IVFPQShard(codes=_tensor(c, device).to(torch.uint8),
                       ids=_tensor(i, device).to(torch.int32),
                       list_len=_tensor(n, device).to(torch.int32))
            for c, i, n in shards]


def datastore(index_cfg: Mapping[str, Any], coarse_centroids: np.ndarray,
              codebooks: np.ndarray,
              shards: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              payload_tokens: Optional[np.ndarray] = None,
              num_vectors: int = 0, device="cpu",
              chunk_table: Optional[np.ndarray] = None):
    """A reference ``Datastore`` (its index config's fields, quantizers,
    shards and payload tables: next tokens [N], RETRO chunks
    [N, chunk_len]) -> the port's ``Datastore``; tables cross as
    int32."""
    from repro_torch.serve.datastore import Datastore
    return Datastore(
        params=ivfpq_params(coarse_centroids, codebooks, device),
        shards=ivfpq_shards(shards, device),
        index_cfg=index_config(index_cfg),
        payload_tokens=None if payload_tokens is None
        else _tensor(payload_tokens, device).to(torch.int32),
        chunk_table=None if chunk_table is None
        else _tensor(chunk_table, device).to(torch.int32),
        num_vectors=num_vectors)
