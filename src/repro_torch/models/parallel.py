"""Autograd collectives of the sharded steps, over the mesh group of the
context in force (``models.ctx``).

Tensor parallelism over "model" (Megatron's pair): ``copy_to_model`` is
the identity forward and an all-reduce of the gradient backward (the
input of a column-split matmul, replicated over the model axis);
``reduce_from_model`` all-reduces forward and passes the gradient
through (the output of a row-split matmul, a partial sum on each rank).
``scatter_to_model`` / ``gather_from_model`` move an activation between
a partial sum and this rank's columns (RWKV-6's channel mix), and
``model_chunk`` keeps this rank's heads of a replicated tensor.

Parameters: ``leaf`` turns a rank's shard of a parameter into what the
layer computes with. A dimension split over a data axis is all-gathered
forward and its gradient reduce-scattered backward (FSDP: each data row
saw other rows of the batch, so the gradients add up), but a MoE's
expert dimension that the layer keeps (expert parallelism); a dimension
split over "model" that the layer does not compute split is all-gathered
forward and its gradient sliced backward (every model rank computed the
same whole gradient from the same replicated activations).
``gather_model_shared`` all-gathers a leaf whose whole each model rank
reads a part of (Mamba's ``w_in``: its x and z columns of its own
channels) and reduce-scatters its gradient. The reductions of gradients
run in float32.

Rows: ``rows_group`` says over which ranks the step's batch rows are
split (training, and the sharded prefill and serve steps); the MoE
gathers them (``gather_rows``, the reference's capacity counts the
global batch), and under expert parallelism every rank's experts'
outputs are gathered over "data" (``gather_experts``).

Serving (the sharded prefill and serve steps, no autograd):
``seq_shard`` says where a cache's K/V slots are split over ranks,
``state_shard`` where a recurrent state's heads, channels or rows are
(the Mamba and RWKV-6 state: a layer computed split over "model" keeps
its heads and channels, ``StateShard.rows_only``; one computed
replicated gathers them whole and cuts them back after),
``gather_model`` moves a small activation's heads between the model
ranks, and ``argmax_over_model`` picks a greedy token from
vocabulary-split logits.

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


class _ScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x.float(), dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous(), ctx.dim), None, None


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


def _group(axis: Optional[str] = None):
    """The rank's group along ``axis`` (default: the model axis) in a
    sharded context, else None (also where the axis has one rank)."""
    ctx = ctx_lib.current()
    if not sharded():
        return None
    axis = ctx.model if axis is None else axis
    return None if ctx.size(axis) == 1 else ctx.axis(axis)


def model_size() -> int:
    """The model axis's size in the sharded context in force (1 outside
    one)."""
    g = _group()
    return 1 if g is None else g.size


def model_rank() -> int:
    """This rank's coordinate on the model axis (0 outside a context)."""
    g = _group()
    return 0 if g is None else g.rank


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    g = _group()
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    g = _group()
    return x if g is None else _ReduceFromModel.apply(x, g)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of every model rank's
    partial ``x`` (a reduce-scatter; the gradient all-gathered)."""
    g = _group()
    return x if g is None else _ScatterModel.apply(x, g, dim)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's chunk ``x`` concatenated along ``dim``, for a
    replicated computation (the gradient: this rank's chunk of it)."""
    g = _group()
    return x if g is None else _GatherModel.apply(x, g, dim)


def gather_model_shared(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A leaf's model-split shard ``x`` all-gathered along ``dim`` for a
    layer whose model ranks each read a part of the whole: the gradient,
    partial on each rank, is summed and reduce-scattered back."""
    g = _group()
    return x if g is None else _GatherData.apply(x, g, dim)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model axis, outside autograd."""
    g = _group()
    return x.detach() if g is None else g.all_reduce(
        x.detach().contiguous().clone(), "max")


def leaf(key: str, x: torch.Tensor, keep_model: bool = False,
         keep_data: bool = False, stacked: bool = False) -> torch.Tensor:
    """The tensor a layer computes with from this rank's shard ``x`` of
    parameter ``key`` (a layer's slice of it when ``stacked``: the spec's
    first entry, the unsharded layer axis, is dropped). Every split dim
    is gathered, except a "model" split when ``keep_model`` (the layer
    computes split over the model axis) and a data-axis split when
    ``keep_data`` (a MoE's experts under expert parallelism). Outside a
    sharded context: ``x``."""
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
            if not keep_data:
                x = _GatherData.apply(x, ctx.axis(live[0]), dim)
        else:
            raise NotImplementedError(f"{key}: axis {live[0]!r}")
    return x


def split_on(key: str, dim: int, ndim: int, axis: Optional[str] = None
             ) -> bool:
    """Whether parameter ``key`` (``ndim`` dims) is split over ``axis``
    (default: the model axis), one of more than one rank, at ``dim`` in
    the context in force."""
    ctx = ctx_lib.current()
    if _group(axis) is None:
        return False
    spec = tuple(ctx.spec(key)) + (None,) * ndim
    return spec[dim % ndim] == (ctx.model if axis is None else axis)


def rows_group():
    """Where the step's activations hold this rank's rows of a batch
    split over the data axes (the context's ``batch`` is the global
    rows): those axes' group, else None (one process, or rows not
    split)."""
    ctx = ctx_lib.current()
    if ctx is None or ctx.group is None or ctx.batch is None:
        return None
    g = ctx.group.over(ctx.dp)
    return g if g.size > 1 else None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` over ``group`` (``rows_group``) in rank
    order, the global batch's order; the gradient of each rank's rows
    summed back to it."""
    return _GatherData.apply(x, group, 0)


def expert_rank() -> int:
    """This rank's shard of a MoE's experts split over "data" (its data
    coordinate; 0 outside a sharded context)."""
    g = _group("data")
    return 0 if g is None else g.rank


def gather_experts(y: torch.Tensor) -> torch.Tensor:
    """Every data rank's experts' outputs ``y`` [E / D, C, d] in rank
    order: [E, C, d] (the gradient reduce-scattered back to each
    expert's owner)."""
    g = _group("data")
    return y if g is None else _GatherData.apply(y, g, 0)


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

    def rows_only(self) -> "StateShard":
        """The splits of the rows alone: a layer computed split over
        "model" keeps the rank's heads and channels as they are."""
        return StateShard(tuple(s for s in self.splits if s[0] == 0))

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


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` (contiguous),
    outside autograd; ``x`` without a model axis."""
    g = _group()
    if g is None:
        return x
    return g.all_gather(x.detach().contiguous(), dim).contiguous()


def model_chunk(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's chunk of ``x`` along ``dim`` (``gather_model``'s
    inverse; under autograd the gradient of the other chunks is 0)."""
    g = _group()
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
    g = _group() if group is None else group
    idx = logits.argmax(-1)
    vals = torch.gather(logits, -1, idx[..., None])[..., 0]
    if g is None or g.size == 1:
        return idx[..., None].int()
    idx = idx + g.rank * logits.shape[-1]
    pair = torch.stack([vals.float(), idx.float()], -1)[None]
    both = g.all_gather(pair.contiguous(), 0)          # [M, ..., 2]
    pick = both[..., 0].argmax(0, keepdim=True)        # first max: lower id
    return torch.gather(both[..., 1], 0, pick)[0][..., None].int()
