"""The dry run's cost counter (twin of ``repro.launch.analysis``).

The reference parses the compiled HLO of its SPMD program. The port's
steps are eager programs, so this counts the aten ops that a step runs
on meta tensors (``count_cost``):

  * flops — ``torch.utils.flop_counter.FlopCounterMode``: the
    matmul-class ops (mm, bmm, addmm, baddbmm, einsum's products,
    convolutions, SDPA), which are the reference's dots;
  * bytes — every aten op that is not a view adds the bytes of its
    tensor operands and outputs: the reference's "operand + output at
    each materialising op" rule (``repro/launch/analysis.py:1-18``)
    applied to eager ops. An op that writes into part of a tensor in
    place (``index_put_``, ``scatter_add_``, ``index_add_``,
    ``index_copy_``) counts its index and update operands and the update
    again as the write, not the whole tensor, as the reference counts a
    scatter. Eager ops are not fused, so every intermediate is written
    and read back: these bytes are an upper bound on what a fused
    program of the same step moves;
  * collective bytes — not counted: they need an SPMD program over
    several devices, and the port's steps run in one process (parameter
    sharding is ROADMAP Queue 1 item 20). They are ``None`` and stay out
    of the dominant term.

The numbers are the whole step's, on one device; the dry run splits
them evenly over a mesh's positions.

Meta tensors have no data, and an op's output metadata is a function of
its inputs' shapes, strides and dtypes and its other arguments, so the
counter memoises each non-view op's output metadata: a loop that
repeats an op on the same shapes (flash attention's tiles, the Mamba
scan's steps) pays for the op's meta kernel once. An op that mutates
its operands always runs, since a replay would not redo an in-place
change of shape or strides (``resize_``, ``transpose_``).

Hardware constants: the H100 SXM5 80GB HBM3 at 700 W.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s (H100 SXM5, tensor cores)
HBM_BW = 3.35e12             # bytes/s (HBM3)

#: in-place ops that write part of ``self``: their update, not ``self``
_PARTIAL_WRITES = ("index_put", "scatter", "index_add", "index_copy",
                   "masked_scatter")


@dataclasses.dataclass
class Cost:
    """A step's FLOPs and bytes; its collective bytes are not counted."""
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def __sub__(self, o: "Cost") -> "Cost":
        return Cost(self.flops - o.flops, self.bytes - o.bytes)

    def scaled(self, t: float) -> "Cost":
        return Cost(self.flops * t, self.bytes * t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or results, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _key(x):
    """A hashable description of an argument: a tensor's metadata, a
    scalar's type and value, sequences element by element."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple((k, _key(v)) for k, v in sorted(x.items()))
    return (type(x).__name__, x)


def _describe(out):
    """An op result's metadata (tensors, or sequences of them), or None
    when it holds anything else or a tensor off the meta device."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) \
            if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)):
        parts = [_describe(o) for o in out]
        return None if any(p is None for p in parts) else (type(out), parts)
    return None


def _rebuild(desc):
    if isinstance(desc[0], type):
        return desc[0](_rebuild(d) for d in desc[1])
    shape, stride, dtype = desc
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class _ByteCounter(TorchDispatchMode):
    """Adds each non-view op's operand and output bytes to ``bytes``,
    and replays a meta op's output metadata from its first run."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self._seen: Dict[Any, Any] = {}

    def _count(self, func, ins, out) -> None:
        outs = _tensors(out, [])
        if func._schema.is_mutable and \
                func.__name__.startswith(_PARTIAL_WRITES):
            rest = ins[1:]
            n = sum(_nbytes(t) for t in rest) + (_nbytes(rest[-1])
                                                 if rest else 0)
        else:
            n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view or func._schema.name in ("aten::detach",
                                                 "aten::alias"):
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs), [])
        key = None
        if not func._schema.is_mutable and \
                all(t.device.type == "meta" for t in ins):
            key = (func, _key(args), _key(kwargs))
        hit = self._seen.get(key) if key is not None else None
        if hit is not None:
            out = _rebuild(hit)
        else:
            out = func(*args, **kwargs)
            desc = _describe(out) if key is not None else None
            if desc is not None:
                self._seen[key] = desc
        self._count(func, ins, out)
        return out


def count_cost(fn: Callable, *args, **kwargs) -> Tuple[Any, Cost]:
    """Run ``fn(*args, **kwargs)`` and count its FLOPs and bytes: (its
    result, ``Cost``). Meant for meta tensors; on a real device it counts
    the same way and computes as well."""
    bytes_mode = _ByteCounter()
    flops_mode = FlopCounterMode(display=False)
    with bytes_mode, flops_mode:
        out = fn(*args, **kwargs)
    return out, Cost(flops=float(flops_mode.get_total_flops()),
                     bytes=float(bytes_mode.bytes))


def roofline_terms(cost: Cost) -> Dict[str, Optional[float]]:
    """Seconds of the three roofline terms on one H100; the collective
    term is None (not counted)."""
    return dict(compute_s=cost.flops / PEAK_FLOPS,
                memory_s=cost.bytes / HBM_BW, collective_s=None)


def dominant_term(terms: Dict[str, Optional[float]]) -> str:
    """The largest counted term; a term that is None is left out."""
    return max((k for k in ("compute_s", "memory_s", "collective_s")
                if terms.get(k) is not None), key=lambda k: terms[k])
