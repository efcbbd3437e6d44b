"""Rank layouts of the retrieval pool and of training (twin of
``repro.launch.mesh``).

The reference's ``make_mesh_for`` lays devices out along named axes
(``data``, ``model``, optionally ``pod``). Here a pool member is a
process, so a ``Mesh`` lays out processes: each position has its
coordinates along the axes and the device its process runs on. Building
a mesh starts nothing. A ``ShardRouter`` over it starts one memory node
per position (``retrieval/fabric.py``), the caller being rank 0; the
training ranks of ``launch.dp`` are a ``data x model`` mesh of their
own (``Group.mesh``: rank r at position r, on ``pool_device(r)``),
whose axis sizes ``models.sharding`` reads to place each rank's shards.

Devices are dealt round-robin over ranks, LM first: the LM pool is
rank 0 on ``cuda:0`` and node rank r runs on ``cuda:(r %
torch.cuda.device_count())``. On one card every process shares
``cuda:0``; on a host with more cards the same rule gives the
reference's layout (the LM on the first card, the nodes on the others).

``make_production_mesh`` lays out the reference's production pods
(16 x 16, or 2 x 16 x 16) for the dry run: its positions are abstract
(device ``"meta"``), and nothing is started for them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the memory-node processes: ``devices[i]`` is the
    device of the node at row-major position ``i``."""
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    devices: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims) or \
                len(self.devices) != math.prod(self.dims):
            raise ValueError(f"mesh {self.axis_names} x {self.dims} needs "
                             f"{math.prod(self.dims)} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, pos: int) -> Dict[str, int]:
        """Row-major coordinates of position ``pos``."""
        out = {}
        for name, dim in reversed(list(zip(self.axis_names, self.dims))):
            pos, out[name] = divmod(pos, dim)
        return {a: out[a] for a in self.axis_names}

    def position(self, coords: Mapping[str, int]) -> int:
        """The position at ``coords``; an axis left out is at 0."""
        pos = 0
        for name, dim in zip(self.axis_names, self.dims):
            pos = pos * dim + coords.get(name, 0)
        return pos


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: ``data x model`` = 16 x 16 (256 positions). Multi-pod:
    ``pod x data x model`` = 2 x 16 x 16 (512); the leading "pod" axis
    is the slow inter-pod hop. Every position's device is ``"meta"``:
    the dry run reads the axes and sizes only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, ("meta",) * math.prod(shape))


def pool_device(rank: int, kind: str) -> str:
    """The device of pool rank ``rank``: CUDA ranks go round-robin over
    the cards, LM (rank 0) first; any other kind is shared by all."""
    if kind == "cuda":
        return f"cuda:{rank % torch.cuda.device_count()}"
    return kind


def make_mesh_for(devices: Optional[Sequence] = None, data: int = 1,
                  model: int = 1, pod: int = 1, *, device=None) -> Mesh:
    """A ``pod x data x model`` mesh (``data x model`` when ``pod`` is 1)
    over ``devices``, or, when they are not given, over pool ranks 1, 2,
    ... (rank 0 is the LM) dealt round-robin on ``device``'s kind: the
    card unless the caller names the CPU (raises without CUDA, like
    every entry point)."""
    n = pod * data * model
    if devices is None:
        kind = device_lib.resolve(device).type
        devices = [pool_device(1 + i, kind) for i in range(n)]
    devices = tuple(str(d) for d in devices)
    if len(devices) < n:
        raise ValueError(f"{n} mesh positions need {n} devices, got "
                         f"{len(devices)}")
    if pod > 1:
        return Mesh(("pod", "data", "model"), (pod, data, model),
                    devices[:n])
    return Mesh(("data", "model"), (data, model), devices[:n])
