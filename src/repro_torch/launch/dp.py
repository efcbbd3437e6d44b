"""Data-parallel training ranks (the port's stand-in for the reference's
``data`` mesh axis).

``launch(size, entry, argv)`` starts ``size`` ranks the way the
retrieval fabric starts its memory nodes: each a fresh interpreter
running ``rank_main`` (``PYTHONPATH`` led by this package's parent),
joined through a private ``TCPStore`` on a free local port into a
process group of its own, never the default group, each with its share
of the host's CPU threads. Rank r runs on
``cuda:(r % device_count)`` (or the CPU) and calls ``entry``
(``"module:function"``) with its ``Group`` and ``argv``. The caller
coordinates but is no rank: it echoes rank 0's output, keeps the last
lines of every rank's, and raises ``RankError`` with them when a rank
fails; the others are then stopped. A rank exits when the caller dies.

The hardware picks the backend (``backend_for``): NCCL where every rank
has a card of its own, gloo otherwise: on the CPU, and where ranks share
one card (NCCL puts no two ranks on one device), with each all-reduce
staged through host memory. The choice is logged by the caller.
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
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import pool_device
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
    """One rank's view of its data-parallel group: its rank, the group's
    size, its device, and the all-reduce over the group."""

    def __init__(self, rank: int, size: int, device, pg=None,
                 backend: str = "none"):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.pg, self.backend = pg, backend

    @classmethod
    def single(cls, device) -> "Group":
        """A group of one: every all-reduce returns its input."""
        return cls(0, 1, device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the group in place ("sum" or "max") and
        return it; gloo on a CUDA tensor goes through a host copy."""
        if self.pg is None:
            return t
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        if self.backend == "gloo" and t.device.type != "cpu":
            host = t.cpu()
            self.pg.allreduce([host], opts).wait()
            return t.copy_(host)
        self.pg.allreduce([t], opts).wait()
        return t


def launch(size: int, entry: str, argv: Sequence[str], device: str = "cuda",
           timeout_s: float = 3600.0) -> List[str]:
    """Run ``entry(group, argv)`` on ``size`` ranks; returns rank 0's
    output lines (also echoed as they come). Raises ``RankError`` when a
    rank exits non-zero or the run outlasts ``timeout_s``."""
    kind = torch.device(device).type
    backend = backend_for(kind, size)
    print(f"[dp] {size} ranks on {kind}, backend {backend}"
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
                   "--size", str(size), "--device", kind,
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


def rank_main(argv: Optional[Sequence[str]] = None) -> None:
    """A rank: join the group, then run its entry."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--entry", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--size", type=int, required=True)
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
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if args.backend == "nccl":
        pg = dist.ProcessGroupNCCL(store, args.rank, args.size)
    else:
        pg = dist.ProcessGroupGloo(store, args.rank, args.size, timeout)
    group = Group(args.rank, args.size, dev, pg, args.backend)
    module, fn = args.entry.split(":")
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    getattr(importlib.import_module(module), fn)(group, rest)
    sys.stdout.flush()
    os._exit(0)
