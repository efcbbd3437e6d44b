"""Activation-sharding context (twin of ``repro.models.ctx``): lets
layer code read the rank's mesh without threading it through every call
signature.

The step builders (``launch/steps.py``) set the context where the
reference's do. Layer code calls ``constrain(x, *dims)`` with logical dim
tags:

  "dp"     -> the compound data-parallel axes ("pod", "data")
  "model"  -> the tensor-parallel axis
  None     -> unsharded

The reference's ``constrain`` is a GSPMD hint. Here each rank holds its
shard in a process of its own, so ``constrain`` is a layout check: it
raises when ``x``'s local shape is not the shard its tags give over the
rank's mesh group, and returns ``x`` unchanged. Outside any context (unit
tests, serving) it does nothing, and inside a context without a group
(the one-process prefill and serve steps) every axis has size 1.

A context with a ``group`` (``launch.dp.Group``) and the keyed partition
specs of the parameters is a sharded step: the layers read their leaves
through ``models.parallel.leaf``, and ``models.parallel``'s autograd
collectives run over the group's axes. A sharded prefill or serve step
also gives the keyed specs of its caches (``caches``): a layer whose
K/V sequence is split over ranks attends over its own slot range and
merges the ranks' partial softmaxes (``models.parallel.seq_shard``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

_CTX: contextvars.ContextVar[Optional["ShardContext"]] = \
    contextvars.ContextVar("shard_ctx", default=None)


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """What ``activation_sharding`` sets. ``group``: the rank's mesh group
    (None in one process); ``specs``: tree key -> sanitised partition
    spec of each parameter leaf (None: the leaves are whole); ``batch``:
    the global rows of the step's (micro-)batch, where known and split;
    ``caches``: tree key -> sanitised spec of each cache leaf (a sharded
    prefill or serve step)."""
    dp: Tuple[str, ...]
    model: str
    kv_batch: Any
    kv_seq: Any
    group: Any = None
    specs: Optional[Dict[str, Any]] = None
    batch: Optional[int] = None
    caches: Optional[Dict[str, Any]] = None

    def size(self, axis: str) -> int:
        """The rank group's size along ``axis`` (1 without a group)."""
        return 1 if self.group is None else self.group.shape.get(axis, 1)

    def axis(self, axis: str):
        """The rank's group along ``axis``."""
        return self.group.axis(axis)

    @property
    def sharded(self) -> bool:
        """Whether the parameters are shards over more than one rank."""
        return self.specs is not None and self.group is not None \
            and self.group.size > 1

    def spec(self, key: str):
        return self.specs[key]

    def _tag_size(self, tag) -> int:
        if tag is None:
            return 1
        if tag == "dp":
            return math.prod(self.size(a) for a in self.dp)
        if tag == "model":
            return self.size(self.model)
        if isinstance(tag, tuple):
            return math.prod(self._tag_size(t) for t in tag)
        return self.size(tag)


@contextlib.contextmanager
def activation_sharding(dp_axes: Tuple[str, ...], model_axis: str = "model",
                        kv_batch="dp", kv_seq="model", *, group=None,
                        specs: Optional[Dict[str, Any]] = None,
                        batch: Optional[int] = None,
                        caches: Optional[Dict[str, Any]] = None):
    """kv_batch / kv_seq: logical tags of the KV cache's batch and
    sequence dims (long_500k flips them: a batch of 1 cannot shard, the
    sequence takes every axis). ``group``, ``specs``, ``batch``,
    ``caches``: see ``ShardContext``."""
    tok = _CTX.set(ShardContext(tuple(dp_axes), model_axis, kv_batch,
                                kv_seq, group, specs, batch, caches))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current() -> Optional[ShardContext]:
    """The context in force, or None."""
    return _CTX.get()


@contextlib.contextmanager
def _enter(ctx: Optional[ShardContext]):
    tok = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(tok)


def recompute_context():
    """A ``torch.utils.checkpoint`` ``context_fn`` that runs the
    recomputed forward under the context in force now: the backward may
    run on another thread (CUDA's autograd thread), which does not see
    this one's context."""
    ctx = current()
    return lambda: (contextlib.nullcontext(), _enter(ctx))


def kv_tags():
    ctx = current()
    if ctx is None:
        return None
    return ctx.kv_batch, ctx.kv_seq


def constrain(x: torch.Tensor, *dims, full=None) -> torch.Tensor:
    """Check ``x``'s layout; returns ``x``. ``dims``: one tag per dim
    ("dp" | "model" | None | a tuple of them); ``full``: the logical
    (global) size of each dim where the caller knows it (None entries,
    or no ``full``, leave a dim unchecked; a "dp" dim is checked against
    the context's global ``batch``). Raises ``ValueError`` on a rank of
    another length or a local size that is not the shard."""
    ctx = current()
    if ctx is None:
        return x
    if len(dims) != x.dim():
        raise ValueError(f"constrain: {len(dims)} tags for a {x.dim()}-d "
                         f"tensor {tuple(x.shape)}")
    full = tuple(full) if full is not None else (None,) * len(dims)
    for i, (tag, size) in enumerate(zip(dims, full)):
        if size is None and tag == "dp":
            size = ctx.batch
        if size is None:
            continue
        n = ctx._tag_size(tag)
        if size % n or x.shape[i] != size // n:
            raise ValueError(
                f"constrain: dim {i} of {tuple(x.shape)} is not the "
                f"{tag!r} shard of {size} over {n} ranks")
    return x
