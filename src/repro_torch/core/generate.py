"""Compatibility shim over ``repro_torch.serve`` (twin of
``repro.core.generate``, the old monolithic entry point).

The generation loop that used to live here was unified into
``repro_torch.serve.engine.RalmEngine``. This module keeps the
historical surface importable:

  * ``RetrievalEngine`` — a deprecated name of
    ``repro_torch.serve.LocalRetriever`` (same fields);
  * ``generate(...)`` — the same signature and semantics, run as a
    one-request ``RalmEngine.monolithic`` engine.

Both warn with ``DeprecationWarning``. New code should use
``repro_torch.serve`` directly.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig
from repro_torch.serve.api import LocalRetriever
from repro_torch.serve.engine import RalmEngine


class RetrievalEngine(LocalRetriever):
    """Deprecated name of ``repro_torch.serve.LocalRetriever``."""

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "repro.core.generate.RetrievalEngine is deprecated; use "
            "repro.serve.LocalRetriever (same fields) or "
            "Datastore.retriever(...)", DeprecationWarning, stacklevel=2)
        super().__init__(*args, **kwargs)


def generate(params, cfg: ModelConfig, rag: RagConfig,
             prompt: torch.Tensor, steps: int,
             engine: Optional[LocalRetriever] = None,
             max_seq: Optional[int] = None, greedy: bool = True,
             rng: Optional[torch.Generator] = None,
             trace: Optional[list] = None) -> np.ndarray:
    """Generate ``steps`` tokens after ``prompt`` [B, T0] on the params'
    device. Returns [B, T0 + steps]. ``rng`` draws the sampled tokens
    when ``greedy`` is False; ``trace`` collects per-step dicts
    (retrieved ids etc.)."""
    warnings.warn(
        "repro.core.generate.generate is deprecated; use "
        "repro.serve.RalmEngine.monolithic(...).generate(...)",
        DeprecationWarning, stacklevel=2)
    ralm = RalmEngine.monolithic(params, cfg, rag, retriever=engine,
                                 max_seq=max_seq)
    return ralm.generate(prompt, steps, greedy=greedy, rng=rng, trace=trace)
