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

Outside a sharded context every function returns its input, so the
one-process paths do not move.
"""
from __future__ import annotations

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
