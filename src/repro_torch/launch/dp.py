"""Training ranks (the port's stand-in for the reference's ``data`` and
``model`` mesh axes).

``launch(size, entry, argv, model=M)`` starts ``size`` ranks the way the
retrieval fabric starts its memory nodes: each a fresh interpreter
running ``rank_main`` (``PYTHONPATH`` led by this package's parent),
joined through a private ``TCPStore`` on a free local port into a
process group of its own, never the default group, each with its share
of the host's CPU threads. The ranks form a ``data x model`` mesh of
``size // M`` x ``M``: rank r sits at row-major coordinates (d, m),
r = d * M + m (the reference's ``make_mesh_for``), and its ``Group``
has one sub-group per axis (the ranks that share its other coordinate),
each a gloo or NCCL group over a ``PrefixStore`` of the same private
store. Rank r runs on
``cuda:(r % device_count)`` (or the CPU) and calls ``entry``
(``"module:function"``) with its ``Group`` and ``argv``. The caller
coordinates but is no rank: it echoes rank 0's output, keeps the last
lines of every rank's, and raises ``RankError`` with them when a rank
fails; the others are then stopped. A rank exits when the caller dies.

The hardware picks the backend (``backend_for``): NCCL where every rank
has a card of its own, gloo otherwise: on the CPU, and where ranks share
one card (NCCL puts no two ranks on one device), with each collective
staged through host memory. The choice is logged by the caller. A
collective that fails raises (gloo's own error, or its timeout after
``GROUP_TIMEOUT_S``); nothing carries on without it.
"""
from __future__ import annotations

import argparse
import collections
import datetime
import importlib
import os
import pathlib
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh, make_mesh_for, pool_device
from repro_torch.runtime.procs import drain, reap, watch_parent

SRC = pathlib.Path(__file__).resolve().parents[2]
HOST = "127.0.0.1"
START_TIMEOUT_S = 600.0          # every rank connected to the store
GROUP_TIMEOUT_S = 3600.0         # one collective
_RANK_ENTRY = "from repro_torch.launch.dp import rank_main; rank_main()"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class RankError(RuntimeError):
    """A training rank failed or did not finish in time."""


def backend_for(kind: str, size: int) -> str:
    """"nccl" where each of ``size`` ranks has a card of its own, else
    "gloo"."""
    if kind == "cuda" and torch.cuda.device_count() >= size:
        return "nccl"
    return "gloo"


class Group:
    """One rank's view of its group of ranks: its rank, the group's size,
    its device, the collectives over the group, and its place in the
    ``data x model`` mesh (``shape``, ``coords``) with one sub-group per
    axis (``axis``). Each collective adds its bytes (its whole buffer:
    the all-reduced tensor, the gathered output, the scattered input)
    and host wall time to ``stats`` (read and reset by the caller)."""

    def __init__(self, rank: int, size: int, device, pg=None,
                 backend: str = "none", model: int = 1,
                 axes: Optional[Dict[str, "Group"]] = None):
        if size % model:
            raise ValueError(f"{size} ranks do not form a mesh with "
                             f"model axis {model}")
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.pg, self.backend = pg, backend
        self.shape = {"data": size // model, "model": model}
        self._axes = dict(axes or {})
        self.stats = {"bytes": 0, "ms": 0.0}

    @classmethod
    def single(cls, device) -> "Group":
        """A group of one: every collective returns its input."""
        return cls(0, 1, device)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's (data, model) coordinates."""
        return dict(zip(("data", "model"),
                        divmod(self.rank, self.shape["model"])))

    @property
    def mesh(self) -> Mesh:
        """The ranks as a ``launch.mesh.Mesh`` (``models.sharding`` reads
        its axis sizes), each rank's device dealt as ``rank_main`` deals
        them."""
        return make_mesh_for([pool_device(r, self.device.type)
                              for r in range(self.size)], **self.shape)

    def axis(self, name: str) -> "Group":
        """The ranks that share this rank's other coordinate: its group
        along ``name`` ("data" or "model")."""
        if self.shape[name] == self.size:
            return self
        if self.shape[name] == 1:
            return self._axes.setdefault(name, Group.single(self.device))
        return self._axes[name]

    def over(self, axes) -> "Group":
        """The ranks that share this rank's coordinates off ``axes`` (mesh
        axis names): the group of a dimension split over those axes, in
        which this rank's rank is its row-major index over them (a split
        over "data" and "model" is the whole mesh, rank d * M + m)."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        live = [a for a in ("data", "model")
                if a in axes and self.shape[a] > 1]
        if len(live) == 2:
            return self
        if live:
            return self.axis(live[0])
        return self._axes.setdefault("none", Group.single(self.device))

    def _run(self, fn, *tensors: torch.Tensor):
        """``fn(*host_or_device tensors)`` waited on, the first tensor the
        output; gloo on CUDA tensors goes through host copies. Adds the
        bytes and wall time to ``stats``."""
        if tensors[0].is_cuda:
            torch.cuda.synchronize(tensors[0].device)
        t0 = time.perf_counter()
        staged = self.backend == "gloo" and tensors[0].device.type != "cpu"
        args = [t.cpu() for t in tensors] if staged else list(tensors)
        fn(*args).wait()
        if staged:
            tensors[0].copy_(args[0])
        if tensors[0].is_cuda:
            torch.cuda.synchronize(tensors[0].device)
        self.stats["ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["bytes"] += max(t.numel() * t.element_size()
                                   for t in tensors)
        return tensors[0]

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the group in place ("sum" or "max") and
        return it."""
        if self.pg is None:
            return t
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        return self._run(lambda x: self.pg.allreduce([x], opts), t)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.pg is None:
            return t
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        self._run(lambda o, x: self.pg._allgather_base(o, x), out, src)
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of every rank's ``t``, cut into ``size`` chunks along
        ``dim``: this rank's chunk."""
        if self.pg is None:
            return t
        src = t.movedim(dim, 0).contiguous()
        if src.shape[0] % self.size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                             f"not split {self.size} ways")
        out = src.new_empty((src.shape[0] // self.size,) + src.shape[1:])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._run(lambda o, x: self.pg._reduce_scatter_base(o, x, opts),
                  out, src)
        return out.movedim(0, dim)


def launch(size: int, entry: str, argv: Sequence[str], device: str = "cuda",
           timeout_s: float = 3600.0, model: int = 1) -> List[str]:
    """Run ``entry(group, argv)`` on ``size`` ranks, a ``size // model``
    x ``model`` mesh; returns rank 0's output lines (also echoed as they
    come). Raises ``RankError`` when a rank exits non-zero or the run
    outlasts ``timeout_s``."""
    kind = torch.device(device).type
    backend = backend_for(kind, size)
    if size % model:
        raise ValueError(f"{size} ranks do not form a mesh with model "
                         f"axis {model}")
    print(f"[dp] {size} ranks on {kind}, backend {backend}"
          + (f", mesh data {size // model} x model {model}"
             if model > 1 else "")
          + (" (staged through host memory)"
             if backend == "gloo" and kind == "cuda" else ""), flush=True)
    store = dist.TCPStore(HOST, 0, size, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=START_TIMEOUT_S))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    procs: List[subprocess.Popen] = []
    tails: List[collections.deque] = []
    lines: List[str] = []
    readers = []
    try:
        for r in range(size):
            cmd = [sys.executable, "-c", _RANK_ENTRY, "--entry", entry,
                   "--port", str(store.port), "--rank", str(r),
                   "--size", str(size), "--model", str(model),
                   "--device", kind,
                   "--backend", backend, "--parent", str(os.getpid()),
                   "--", *argv]
            procs.append(subprocess.Popen(
                cmd, env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            tails.append(collections.deque(maxlen=60))
            target = _echo if r == 0 else drain
            args = ((procs[r].stdout, tails[r], lines) if r == 0
                    else (procs[r].stdout, tails[r]))
            readers.append(threading.Thread(target=target, args=args,
                                            daemon=True))
            readers[-1].start()
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise RankError(f"rank {r} exited with code "
                                    f"{p.returncode}:\n" + "".join(tails[r]))
            if time.monotonic() > deadline:
                raise RankError(f"ranks did not finish in {timeout_s:.0f} s")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RankError(f"rank {r} exited with code {p.returncode}:"
                                "\n" + "".join(tails[r]))
    finally:
        reap(procs)
        for th in readers:
            th.join(5.0)
    return lines


def _echo(stream, tail: collections.deque, lines: List[str]) -> None:
    """Rank 0's output: echoed, kept whole and in the tail."""
    for line in stream:
        print(line, end="", flush=True)
        lines.append(line.rstrip("\n"))
        tail.append(line)


def _process_group(store, rank: int, size: int, backend: str):
    if backend == "nccl":
        return dist.ProcessGroupNCCL(store, rank, size)
    return dist.ProcessGroupGloo(
        store, rank, size, datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _mesh_group(store, rank: int, size: int, model: int, dev,
                backend: str) -> Group:
    """Rank ``rank``'s group over all ``size`` ranks, with a sub-group
    for each mesh axis of more than one rank that is not the whole mesh:
    along "data" the ranks of its model column (prefix ``data/<m>``),
    along "model" those of its data row (``model/<d>``)."""
    data = size // model
    d, m = divmod(rank, model)
    axes = {}
    pg = _process_group(store, rank, size, backend)
    if 1 < data < size:
        axes["data"] = Group(d, data, dev, _process_group(
            dist.PrefixStore(f"data/{m}", store), d, data, backend), backend)
    if 1 < model < size:
        axes["model"] = Group(m, model, dev, _process_group(
            dist.PrefixStore(f"model/{d}", store), m, model, backend),
            backend)
    return Group(rank, size, dev, pg, backend, model=model, axes=axes)


def rank_main(argv: Optional[Sequence[str]] = None) -> None:
    """A rank: join the group, then run its entry."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--entry", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--size", type=int, required=True)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--parent", type=int, required=True)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    watch_parent(args.parent)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.size))
    dev = torch.device(pool_device(args.rank, args.device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore(HOST, args.port, args.size, False,
                          timeout=datetime.timedelta(seconds=START_TIMEOUT_S))
    group = _mesh_group(store, args.rank, args.size, args.model, dev,
                        args.backend)
    module, fn = args.entry.split(":")
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    getattr(importlib.import_module(module), fn)(group, rest)
    sys.stdout.flush()
    os._exit(0)
