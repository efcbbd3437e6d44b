"""Abstract stand-ins for every model and engine input (twin of
``repro.launch.specs``): the dry run runs its steps on these.

A "struct" is a tensor on the meta device, torch's counterpart of
``jax.ShapeDtypeStruct``: a shape and a dtype, no storage.

The vector database is described at the paper's scale (1e9 vectors,
Table 3) with a per-model width: query dim = min(d_model, 1024) (wider
models project the hidden state down before the search, as OPQ does;
the projection is a serve-time parameter), m = query dim / 16 (the
paper's dsub = 16 on every dataset).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import SHAPES, ArchSpec
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.ivfpq import IVFPQConfig, IVFPQParams, IVFPQShard
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import P, dp_axes


def S(shape, dtype) -> torch.Tensor:
    """A struct: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ServeDBSpec:
    """Deployment-scale retrieval database (paper Table 3). ``residual``
    is the index's PQ encoding (the reference fixes it to True); a
    caller serving a non-residual index built by ``DatastoreBuilder``
    (its default) sets it False."""
    n_vectors: int = 1_000_000_000
    nlist: int = 32768
    nprobe: int = 32
    nbits: int = 8
    residual: bool = True

    def for_model(self, cfg: ModelConfig, num_shards: int, k: int
                  ) -> ChamVSConfig:
        dq = min(cfg.d_model, 1024)
        m = max(dq // 16, 4)
        per = self.n_vectors / self.nlist / num_shards
        cap = int(-(-per * 1.10 // 128) * 128)  # +10% imbalance headroom
        icfg = IVFPQConfig(dim=dq, nlist=self.nlist, m=m, nbits=self.nbits,
                           residual=self.residual, list_cap=max(cap, 128))
        return ChamVSConfig(ivfpq=icfg, nprobe=self.nprobe, k=k)


def db_struct(ccfg: ChamVSConfig, num_shards: int
              ) -> Tuple[IVFPQParams, IVFPQShard]:
    i = ccfg.ivfpq
    params = IVFPQParams(
        coarse_centroids=S((i.nlist, i.dim), torch.float32),
        codebooks=S((i.m, i.ksub, i.dsub), torch.float32))
    shard = IVFPQShard(
        codes=S((num_shards, i.nlist, i.list_cap, i.m), torch.uint8),
        ids=S((num_shards, i.nlist, i.list_cap), torch.int32),
        list_len=S((num_shards, i.nlist), torch.int32))
    return params, shard


def db_specs(mesh) -> Tuple[Any, Any]:
    """Partition specs of (IVFPQParams, the stacked IVFPQShard)."""
    dp = dp_axes(mesh)
    return (IVFPQParams(P(), P()),
            IVFPQShard(codes=P(dp), ids=P(dp), list_len=P(dp)))


def num_db_shards(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


# ---------------------------------------------------------------------------
# per-(arch, shape) input structs
# ---------------------------------------------------------------------------

def enc_len(spec: ArchSpec) -> int:
    """An encoder-decoder's encoder rows: 512 audio frames, or the K
    retrieved chunks of ``chunk_len`` tokens."""
    cfg = spec.model
    return 512 if cfg.frontend == "audio" else spec.rag.k * spec.rag.chunk_len


def train_batch_struct(spec: ArchSpec, shape_name: str) -> Dict[str, Any]:
    sh = SHAPES[shape_name]
    B, T = sh["global_batch"], sh["seq_len"]
    cfg = spec.model
    batch: Dict[str, Any] = {"labels": S((B, T), torch.int32)}
    if cfg.frontend == "vision":
        # patch embeddings from the stub frontend + M-RoPE position streams
        batch["embeds"] = S((B, T, cfg.d_model), cfg.torch_dtype)
        batch["positions"] = S((3, B, T), torch.int32)
    else:
        batch["tokens"] = S((B, T), torch.int32)
    if cfg.arch == "encdec":
        batch["enc_embeds"] = S((B, enc_len(spec), cfg.d_model),
                                cfg.torch_dtype)
    return batch


def train_batch_specs(spec: ArchSpec, shape_name: str, mesh
                      ) -> Dict[str, Any]:
    dp = dp_axes(mesh)
    cfg = spec.model
    out: Dict[str, Any] = {"labels": P(dp, None)}
    if cfg.frontend == "vision":
        out["embeds"] = P(dp, None, None)
        out["positions"] = P(None, dp, None)
    else:
        out["tokens"] = P(dp, None)
    if cfg.arch == "encdec":
        out["enc_embeds"] = P(dp, None, None)
    return out


def prefill_struct(spec: ArchSpec, shape_name: str) -> Dict[str, Any]:
    sh = SHAPES[shape_name]
    B, T = sh["global_batch"], sh["seq_len"]
    cfg = spec.model
    batch: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        batch["embeds"] = S((B, T, cfg.d_model), cfg.torch_dtype)
        batch["positions"] = S((3, B, T), torch.int32)
    else:
        batch["tokens"] = S((B, T), torch.int32)
        batch["positions"] = S((B, T), torch.int32)
    if cfg.arch == "encdec":
        batch["enc_embeds"] = S((B, enc_len(spec), cfg.d_model),
                                cfg.torch_dtype)
    return batch


def decode_struct(spec: ArchSpec, shape_name: str) -> Dict[str, Any]:
    B = SHAPES[shape_name]["global_batch"]
    cfg = spec.model
    batch: Dict[str, Any] = {
        "token": S((B, 1), torch.int32),
        "position": S((B,), torch.int32),
    }
    if cfg.arch == "encdec":
        batch["enc_states"] = S((B, enc_len(spec), cfg.d_model),
                                cfg.torch_dtype)
    return batch


def cache_struct(spec: ArchSpec, shape_name: str) -> Any:
    """Abstract decode caches (``transformer.init_cache`` on meta) for
    the shape's batch and KV length."""
    from repro_torch.models import transformer as tf
    sh = SHAPES[shape_name]
    cfg = spec.model
    return tf.init_cache(cfg, sh["global_batch"], max_seq=sh["seq_len"],
                         device="meta",
                         enc_len=enc_len(spec) if cfg.arch == "encdec"
                         else 0)
