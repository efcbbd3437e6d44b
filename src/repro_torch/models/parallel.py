"""Autograd collectives of the sharded training step, over the mesh
group of the context in force (``models.ctx``).

Tensor parallelism over "model" (Megatron's pair): ``copy_to_model`` is
the identity forward and an all-reduce of the gradient backward (the
input of a column-split matmul, replicated over the model axis);
``reduce_from_model`` all-reduces forward and passes the gradient
through (the output of a row-split matmul, a partial sum on each rank).

Parameters: ``leaf`` turns a rank's shard of a parameter into what the
layer computes with. A dimension split over a data axis is all-gathered
forward and its gradient reduce-scattered backward (FSDP: each data row
saw other rows of the batch, so the gradients add up); a dimension split
over "model" that the layer does not compute split is all-gathered
forward and its gradient sliced backward (every model rank computed the
same whole gradient from the same replicated activations). The
reductions of gradients run in float32.

Serving (the sharded prefill and serve steps, no autograd):
``seq_shard`` says where a cache's K/V slots are split over ranks,
``state_shard`` where a recurrent state's heads, channels or rows are
(the Mamba and RWKV-6 state, gathered whole for a layer computed
replicated and cut back after), ``rows_group`` over which ranks the
step's batch rows are split (the MoE routes the whole batch),
``gather_model`` / ``model_chunk`` move a small activation's heads
between the model ranks, and ``argmax_over_model`` picks a greedy token
from vocabulary-split logits.

Outside a sharded context every function returns its input, so the
one-process paths do not move.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import ctx as ctx_lib


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.dtype = group, dim, x.dtype
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        out = ctx.group.reduce_scatter(g.float(), ctx.dim).to(ctx.dtype)
        return out, None, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.group.size
        return g.narrow(ctx.dim, ctx.group.rank * n, n), None, None


def sharded() -> bool:
    """Whether a sharded context is in force."""
    ctx = ctx_lib.current()
    return ctx is not None and ctx.sharded


def _model_group():
    """The rank's model-axis group in a sharded context, else None."""
    ctx = ctx_lib.current()
    if not sharded() or ctx.size(ctx.model) == 1:
        return None
    return ctx.axis(ctx.model)


def model_size() -> int:
    """The model axis's size in the sharded context in force (1 outside
    one)."""
    g = _model_group()
    return 1 if g is None else g.size


def model_rank() -> int:
    """This rank's coordinate on the model axis (0 outside a context)."""
    g = _model_group()
    return 0 if g is None else g.rank


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    g = _model_group()
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    g = _model_group()
    return x if g is None else _ReduceFromModel.apply(x, g)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model axis, outside autograd."""
    g = _model_group()
    return x.detach() if g is None else g.all_reduce(
        x.detach().contiguous().clone(), "max")


def leaf(key: str, x: torch.Tensor, keep_model: bool = False,
         stacked: bool = False) -> torch.Tensor:
    """The tensor a layer computes with from this rank's shard ``x`` of
    parameter ``key`` (a layer's slice of it when ``stacked``: the spec's
    first entry, the unsharded layer axis, is dropped). Every split dim
    is gathered, except a "model" split when ``keep_model`` (the layer
    computes split over the model axis). Outside a sharded context:
    ``x``."""
    if not sharded():
        return x
    ctx = ctx_lib.current()
    spec = tuple(ctx.spec(key))[1 if stacked else 0:]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        live = [a for a in axes if ctx.size(a) > 1]
        if len(live) > 1:
            raise NotImplementedError(
                f"{key}: dim {dim} split over {axes}; the training mesh "
                "splits a dim over one axis")
        if not live:
            continue
        if live[0] == ctx.model:
            if not keep_model:
                x = _GatherModel.apply(x, ctx.axis(ctx.model), dim)
        elif live[0] in ctx.dp:
            x = _GatherData.apply(x, ctx.axis(live[0]), dim)
        else:
            raise NotImplementedError(f"{key}: axis {live[0]!r}")
    return x


def split_on(key: str, dim: int, ndim: int) -> bool:
    """Whether parameter ``key`` (``ndim`` dims) is split over the model
    axis at ``dim`` in the context in force."""
    ctx = ctx_lib.current()
    if _model_group() is None:
        return False
    spec = tuple(ctx.spec(key)) + (None,) * ndim
    return spec[dim % ndim] == ctx.model


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A cache whose slots are split over ``group``: this rank holds
    chunk ``index`` (its slot 0 is global slot ``index * S_local``: that
    absolute position in a linear cache)."""
    group: Any
    index: int

    def offset(self, local_len: int) -> int:
        return self.index * local_len

    def where(self, local_len: int, ring: bool = False) -> dict:
        """The cache writers' and the partial mode's keywords for this
        rank's ``local_len`` slots: its slot offset and, for a ``ring``,
        the ring's slots in all."""
        return dict(ring=ring, slot_offset=self.offset(local_len),
                    ring_size=local_len * self.group.size)


def _cache_splits(key: str) -> list:
    """(dim, group) of every dim of the cache leaf ``key`` split over
    live axes in the context in force (dims of the stacked leaf), or []
    (no split, or no sharded serving context)."""
    ctx = ctx_lib.current()
    if not sharded() or not ctx.caches or key not in ctx.caches:
        return []
    out = []
    for dim, entry in enumerate(tuple(ctx.caches[key])):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if any(ctx.size(a) > 1 for a in axes):
            out.append((dim, ctx.group.over(axes)))
    return out


def seq_shard(key: str) -> Optional[SeqShard]:
    """Where the cache leaf ``key`` ([n, B, S, ...]) splits its slots
    (dim 2) over ranks in the context in force, or None (not split, or
    no sharded serving context)."""
    g = dict(_cache_splits(key)).get(2)
    return None if g is None else SeqShard(g, g.rank)


@dataclasses.dataclass(frozen=True)
class StateShard:
    """A layer's recurrent-state cache leaf ([B, ...]: rows first) split
    over ranks: ``splits``, (dim, group) of each split dim. A layer that
    computes the state replicated reads it ``whole`` and writes back its
    ``mine``."""
    splits: tuple

    def whole(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """Every split dim of the rank's ``x`` all-gathered, but the rows
        where ``x`` already holds the ``rows`` the layer computes (its
        activations' rows, split as the state's)."""
        for dim, g in self.splits:
            if dim == 0 and x.shape[0] == rows:
                continue
            x = g.all_gather(x.contiguous(), dim)
        return x

    def mine(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """The rank's chunk of ``whole``'s ``x``, shaped as ``like``."""
        for dim, g in self.splits:
            n = like.shape[dim]
            if x.shape[dim] != n:
                x = x.narrow(dim, g.rank * n, n)
        return x


def state_shard(key: str) -> StateShard:
    """Where the cache leaf ``key`` ([n, B, ...], the layer axis first)
    splits a layer's state over ranks (no splits: whole)."""
    return StateShard(tuple((dim - 1, g) for dim, g in _cache_splits(key)
                            if dim))


def rows_group():
    """In a sharded serving step whose activations hold this rank's rows
    of a batch split over the data axes: those axes' group, else None
    (training, one process, or rows not split)."""
    ctx = ctx_lib.current()
    if not sharded() or ctx.caches is None or ctx.batch is None:
        return None
    g = ctx.group.over(ctx.dp)
    return g if g.size > 1 else None


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` (contiguous),
    outside autograd; ``x`` without a model axis."""
    g = _model_group()
    if g is None:
        return x
    return g.all_gather(x.detach().contiguous(), dim).contiguous()


def model_chunk(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's chunk of ``x`` along ``dim`` (``gather_model``'s
    inverse)."""
    g = _model_group()
    if g is None:
        return x
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * n, n)


def argmax_over_model(logits: torch.Tensor, group=None) -> torch.Tensor:
    """Greedy token ids [..., 1] (int32) from ``logits`` [..., V_local],
    this rank's vocabulary columns of a split over the model axis (the
    whole vocabulary without one): the largest value over every rank's
    columns, ties to the lower id. ``group``: the model axis's ranks
    (default: the context's)."""
    g = _model_group() if group is None else group
    idx = logits.argmax(-1)
    vals = torch.gather(logits, -1, idx[..., None])[..., 0]
    if g is None or g.size == 1:
        return idx[..., None].int()
    idx = idx + g.rank * logits.shape[-1]
    pair = torch.stack([vals.float(), idx.float()], -1)[None]
    both = g.all_gather(pair.contiguous(), 0)          # [M, ..., 2]
    pick = both[..., 0].argmax(0, keepdim=True)        # first max: lower id
    return torch.gather(both[..., 1], 0, pick)[0][..., None].int()
