"""Traffic: a mix file ``traffic/<mix>.json`` names its generator by its
``kind`` (``traffic/<kind>.py``), which reads the rest of the file.

A generator module defines ``KEYS``, the mix keys it reads, and
``Traffic(mix, seed, vocab, device)`` with:

- ``max_seq``: the longest prompt plus the longest answer it offers;
- ``slots``: the rows the engine's KV pool holds for it;
- ``due(now, steps)``: the requests to submit before scheduler step
  ``steps`` (1-based) at host time ``now``;
- ``after(req)``: the requests to submit once ``req`` has finished;
- ``warmed``: true once the warm-up has seen a steady mix.

Every mix also carries ``check_requests`` and ``check_queries``, which
the comparison reads (``check.py``).
"""
from __future__ import annotations

import array
import dataclasses
import importlib
import json
import pathlib
from typing import Optional

import torch

CHECK_KEYS = ("check_requests", "check_queries")


@dataclasses.dataclass
class Request:
    """One offered request and what the harness saw of it. Only a traced
    request keeps its prompt, its tokens and its neighbours past its end
    (for the check); the token times are a flat array, so the harness's
    own objects do not grow with every token."""
    j: int
    client: int
    prompt: Optional[torch.Tensor]  # [rows, T0] on the device
    rows: int
    prompt_len: int
    steps: int
    traced: bool
    t_submit: float = 0.0
    times: array.array = dataclasses.field(
        default_factory=lambda: array.array("d"))          # per token
    tokens: Optional[list] = None   # traced: [rows] host arrays a token
    neighbours: Optional[list] = None  # traced: (step, dists, ids) on device
    partial: int = 0                # steps served on partial retrieval


def load(name: str, root: pathlib.Path) -> dict:
    """The mix ``name`` from ``root``'s ``ralm_bench/traffic/``, checked
    against the keys its generator reads."""
    mix = json.loads((root / "ralm_bench" / "traffic" / f"{name}.json")
                     .read_text())
    if "kind" not in mix:
        raise ValueError(f"traffic {name}: no 'kind'")
    missing = [k for k in generator(mix).KEYS + CHECK_KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    return mix


def generator(mix: dict):
    """The module that generates ``mix``'s kind of traffic."""
    return importlib.import_module(f"ralm_bench.traffic.{mix['kind']}")
