"""The retrieval pool's fabric: memory-node processes and the messages
between them and the coordinator. In the reference the fabric is XLA's
collectives inside ``shard_map``; here it is point-to-point messages
over a gloo process group.

A pool member is a process. ``Fabric(devices)`` starts one memory node
per device as a fresh interpreter running ``node_main`` (CUDA does not
survive ``fork``, and nothing re-runs the caller's ``__main__``), with
``PYTHONPATH`` led by this package's parent. The caller is rank 0, the
coordinator; node ``i`` is rank ``i + 1``. Each fabric owns its own
``ProcessGroupGloo`` over its own ``TCPStore`` on a free local port,
never the default group, so one process can hold several fabrics at
once. A node runs one intra-op CPU thread: the nodes share the host
with the coordinator.

A message is its JSON meta (the op, and each tensor's dtype and shape)
and its tensors, packed into one buffer up to ``MSG_BYTES``. A gloo
send completes only into a posted receive, so each side posts the
receive of the other's next message ahead of time (a message may be
shorter than the buffer posted for it): a gather, or a search's reply,
is one send. A larger message (a search's queries, a shard at
placement) sends its tensors after the JSON, their receives posted
together. Every tensor crosses through host memory: the sender stages
it with ``.cpu()``, the receiver moves it to its device.

A node keeps the objects placed on it by name (``place``) and serves,
on its device: ``search`` (the IVF probe kernel's wrapper on its
queries, then ``core.chamvs.shard_search``, whose scan is ``adc_scan``,
on its shard), ``gather`` (its row range of a payload table, the other
ids masked to 0), ``stats`` (device name, kernel launch counts, ops
served, peak memory) and ``reset``. A node that raises, a kernel that
fails to build or launch included, sends the error text back and the
coordinator raises ``FabricError``; nothing is retried and nothing runs
elsewhere instead.

Lifetime (the reference's single controller had none to manage):
``close()`` stops the nodes and joins them, killing any that outlive
the join timeout; a ``weakref.finalize`` hook, which also runs at
interpreter exit, kills the nodes of a fabric dropped or left open; a
node exits when its connection to the coordinator closes, and a
watchdog thread exits it when the coordinator's process is gone. Every
wait of the coordinator is bounded: start-up by ``START_TIMEOUT_S``,
each message by ``timeout_s`` (a fabric whose message timed out is
closed: its stream can no longer be trusted), the join by
``JOIN_TIMEOUT_S``. A node waits for its next message as long as its
coordinator lives.

Counters (measurement attributes, like the kernels' launch counts): per
op, the calls (one round trip each, to every node addressed at once),
the bytes each way, and the host wall seconds of the coordinator and of
the slowest node's own handling.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import datetime
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import traceback
import weakref
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime.procs import drain, reap, watch_parent

SRC = pathlib.Path(__file__).resolve().parents[2]
TAG_MSG, TAG_DATA = 0, 1
MSG_BYTES = 1 << 15             # a message packed whole up to this size
#                                 (a search's survivors, a gather's ids and
#                                 payload) goes in one send; past it (a
#                                 wave's 64 KiB of queries) packed sends
#                                 were slower and had a long tail
#                                 (tools/fabric_rtt.py)
ALIGN = 16                      # packed tensors' offsets
HOST = "127.0.0.1"
START_TIMEOUT_S = 600.0         # nodes started and connected
JOIN_TIMEOUT_S = 30.0           # nodes exited after ``stop``
NODE_IDLE_S = 7 * 24 * 3600     # a node's wait for its next message; the
#                                 coordinator's death ends it sooner
NODE_THREADS = 1                # intra-op CPU threads a node: the nodes
#                                 share the host with the coordinator, and
#                                 more threads each made CPU searches
#                                 slower through contention
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64,
           "uint8": torch.uint8, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}
# the node's entry; ``-m repro_torch.retrieval.fabric`` works as well, but
# imports this module twice (once with its package, once as __main__)
_NODE_ENTRY = "from repro_torch.retrieval.fabric import node_main; node_main()"


class FabricError(RuntimeError):
    """A memory node raised, died or did not answer in time."""


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _post(pg, peer: int, meta: dict, tensors: Sequence[torch.Tensor]):
    """Start sending one message: its length, its JSON and its tensors
    packed into one buffer when they fit ``MSG_BYTES`` (one send, into
    the receive the peer posted ahead), else the length and JSON first
    and each tensor after it on ``TAG_DATA``. Returns (works, the host
    buffers the works read from, which must outlive them, bytes)."""
    host = [t.detach().cpu().contiguous() for t in tensors]
    for t in host:
        if t.dtype not in _NAMES:
            raise TypeError(f"fabric: no wire format for {t.dtype}")
    sizes = [t.numel() * t.element_size() for t in host]
    text = json.dumps(dict(meta, tensors=[[_NAMES[t.dtype], list(t.shape)]
                                          for t in host])).encode()
    start = _align(8 + len(text))
    inline = start + sum(_align(n) for n in sizes) <= MSG_BYTES
    end = start + sum(_align(n) for n in sizes) if inline else 8 + len(text)
    if end > MSG_BYTES:
        raise ValueError(f"fabric: a {len(text)}-byte message head")
    msg = torch.zeros(end, dtype=torch.uint8)
    msg[:8] = torch.tensor([len(text) * (1 if inline else -1)],
                           dtype=torch.int64).view(torch.uint8)
    msg[8:8 + len(text)] = torch.frombuffer(bytearray(text),
                                            dtype=torch.uint8)
    data = []
    if inline:
        off = start
        for t, n in zip(host, sizes):
            msg[off:off + n] = t.reshape(-1).view(torch.uint8)
            off += _align(n)
    else:
        data = [t for t in host if t.numel()]
    works = [pg.send([msg], peer, TAG_MSG)] + \
        [pg.send([t], peer, TAG_DATA) for t in data]
    return works, [msg] + data, end + sum(
        t.numel() * t.element_size() for t in data)


def _expect(pg, peer: int, buf: torch.Tensor):
    """Post the receive of ``peer``'s next message into ``buf`` (one
    per peer, ``MSG_BYTES``, reused: ``_finish`` copies out of it);
    returns (buf, work). Posted before the message is sent, it lets the
    send go out at once."""
    return buf, pg.recv([buf], peer, TAG_MSG)


def _finish(pg, peer: int, buf: torch.Tensor
            ) -> Tuple[dict, List[torch.Tensor], int]:
    """Unpack the message that arrived in ``buf`` (receiving its tensors
    after it, posted together, when they were not packed in): (meta,
    host tensors, bytes). Each wait is bounded by the group's timeout."""
    n = int(buf[:8].view(torch.int64)[0])
    inline, n = n >= 0, abs(n)
    meta = json.loads(bytes(buf[8:8 + n].numpy()).decode())
    specs = meta.pop("tensors")
    tensors, off = [], _align(8 + n)
    for dtype, shape in specs:
        t = torch.empty(shape, dtype=_DTYPES[dtype])
        if inline:
            size = t.numel() * t.element_size()
            t.reshape(-1).view(torch.uint8).copy_(buf[off:off + size])
            off += _align(size)
        tensors.append(t)
    if not inline:
        for w in [pg.recv([t], peer, TAG_DATA)
                  for t in tensors if t.numel()]:
            w.wait()
        off = 8 + n
    return meta, tensors, (off if inline else off + sum(
        t.numel() * t.element_size() for t in tensors))


# ---------------------------------------------------------------------------
# the coordinator's side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpCounter:
    """One op's traffic: calls (round trips), bytes each way, host wall
    seconds on the coordinator and on the nodes."""
    round_trips: int = 0
    bytes_out: int = 0
    bytes_in: int = 0
    seconds: float = 0.0
    node_seconds: float = 0.0     # the slowest node's own handling time a
    #                               call (host wall, its device waits
    #                               included), summed: the rest of
    #                               ``seconds`` is the fabric's


class Fabric:
    """One coordinator and ``len(devices)`` memory-node processes."""

    def __init__(self, devices: Sequence, *, timeout_s: float = 300.0):
        """Start a node on each of ``devices`` and connect to them;
        ``timeout_s`` bounds each wait for a message. On CUDA the kernel
        library is built here first, so that the nodes load it instead
        of each compiling it."""
        self.devices = tuple(str(d) for d in devices)
        self.size = len(self.devices)
        self.timeout_s = timeout_s
        self.counters: Dict[str, OpCounter] = {}
        self._names = 0
        self._pg = None
        self._closed = False
        self._procs: List[subprocess.Popen] = []
        self._inbox = [torch.empty(MSG_BYTES, dtype=torch.uint8)
                       for _ in self.devices]
        self._tails: List[collections.deque] = []
        self._finalizer = weakref.finalize(self, reap, self._procs)
        if any(torch.device(d).type == "cuda" for d in self.devices):
            from repro_torch.kernels import _build
            _build.library()
        store = dist.TCPStore(
            HOST, 0, self.size + 1, True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=START_TIMEOUT_S))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        try:
            for i, dev in enumerate(self.devices):
                cmd = [sys.executable, "-c", _NODE_ENTRY,
                       "--port", str(store.port), "--rank", str(i + 1),
                       "--world", str(self.size + 1), "--device", dev,
                       "--parent", str(os.getpid())]
                proc = subprocess.Popen(
                    cmd, env=env, stdin=subprocess.DEVNULL,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                self._procs.append(proc)
                tail = collections.deque(maxlen=60)
                self._tails.append(tail)
                threading.Thread(target=drain, args=(proc.stdout, tail),
                                 daemon=True).start()
            self._pg = self._connect(store, time.monotonic() +
                                     START_TIMEOUT_S)
        except BaseException:
            self.close()
            raise
        self._store = store

    def _connect(self, store, deadline: float):
        """Wait until every node has started (each sets its key in the
        store just before joining the group), watching the nodes: one
        that exits during start-up raises with its output. Then build
        the group on a thread, watched the same way."""
        keys = [f"ready/{r}" for r in range(1, self.size + 1)]
        while not store.check(keys):
            self._watch_start(deadline)
            time.sleep(0.05)
        box: dict = {}

        def make():
            try:
                box["pg"] = dist.ProcessGroupGloo(
                    store, 0, self.size + 1,
                    datetime.timedelta(seconds=self.timeout_s))
            except BaseException as err:      # reported on the caller
                box["err"] = err

        th = threading.Thread(target=make, daemon=True)
        th.start()
        while th.is_alive():
            th.join(0.05)
            self._watch_start(deadline)
        if "err" in box:
            raise FabricError(f"fabric start-up: {box['err']}") \
                from box["err"]
        return box["pg"]

    def _watch_start(self, deadline: float) -> None:
        for i, p in enumerate(self._procs):
            if p.poll() is not None:
                raise FabricError(
                    f"memory node {i + 1} ({self.devices[i]}) exited with "
                    f"code {p.returncode} during start-up:\n"
                    + self.output(i))
        if time.monotonic() > deadline:
            raise FabricError("memory nodes did not connect in time:\n"
                              + "\n".join(self.output(i)
                                          for i in range(self.size)))

    # -- introspection ------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def alive(self) -> List[bool]:
        """Whether each node's process is running."""
        return [p.poll() is None for p in self._procs]

    def output(self, node: int) -> str:
        """The last lines a node printed (its start-up errors)."""
        return "".join(self._tails[node]) if node < len(self._tails) \
            else ""

    def new_name(self, prefix: str) -> str:
        """A fresh name for an object placed on the nodes."""
        self._names += 1
        return f"{prefix}{self._names}"

    # -- messages -----------------------------------------------------------

    def call(self, op: str,
             requests: Mapping[int, Tuple[dict, Sequence[torch.Tensor]]]
             ) -> Dict[int, Tuple[dict, List[torch.Tensor]]]:
        """One round trip: send each addressed node (index -> (meta,
        tensors)) its request, all at once, then receive every reply.
        Returns node -> (meta, host tensors). Raises ``FabricError`` when
        a node raised (after every reply is in, so the fabric stays
        usable), or when one died or timed out (the fabric is closed)."""
        if self._closed:
            raise FabricError("the fabric is closed")
        t0 = time.perf_counter()
        sent, heads, out_bytes, in_bytes = [], {}, 0, 0
        replies: Dict[int, Tuple[dict, List[torch.Tensor]]] = {}
        try:
            for node, (meta, tensors) in requests.items():
                heads[node] = _expect(self._pg, node + 1, self._inbox[node])
                works, bufs, nb = _post(self._pg, node + 1,
                                        dict(meta, op=op), tensors)
                sent.append((works, bufs))
                out_bytes += nb
            for node, (head, work) in heads.items():
                work.wait()
                meta, tensors, nb = _finish(self._pg, node + 1, head)
                replies[node] = (meta, tensors)
                in_bytes += nb
            for works, _ in sent:
                for w in works:
                    w.wait()
        except Exception as err:
            dead = [f"node {i + 1}: exited with {p.returncode}\n"
                    + self.output(i)
                    for i, p in enumerate(self._procs) if p.poll() is not None]
            self.close(stop=False)
            raise FabricError(f"fabric {op!r} failed ({err}); the fabric is "
                              "closed\n" + "\n".join(dead)) from err
        c = self.counters.setdefault(op, OpCounter())
        c.round_trips += 1
        c.bytes_out += out_bytes
        c.bytes_in += in_bytes
        c.seconds += time.perf_counter() - t0
        c.node_seconds += max((m.get("t", 0.0) for m, _ in replies.values()),
                              default=0.0)
        errors = [f"memory node {node + 1} ({self.devices[node]}) raised in "
                  f"{op!r}:\n{meta.get('error')}"
                  for node, (meta, _) in replies.items() if not meta["ok"]]
        if errors:
            raise FabricError("\n".join(errors))
        return replies

    def broadcast(self, op: str, meta: Optional[dict] = None,
                  tensors: Sequence[torch.Tensor] = ()
                  ) -> List[Tuple[dict, List[torch.Tensor]]]:
        """The same request to every node; replies in node order."""
        out = self.call(op, {i: (meta or {}, tensors)
                             for i in range(self.size)})
        return [out[i] for i in range(self.size)]

    def stats(self) -> List[dict]:
        """Each node's device name, kernel launch counts, searches and
        gathers served, and peak memory since the last ``reset``."""
        return [m for m, _ in self.broadcast("stats")]

    def reset(self) -> None:
        """Zero every node's launch counts, op counts and peak memory."""
        self.broadcast("reset")

    def reset_counters(self) -> None:
        self.counters.clear()

    # -- lifetime -----------------------------------------------------------

    def close(self, stop: bool = True) -> None:
        """Stop the nodes and join them, killing any still running after
        ``JOIN_TIMEOUT_S``; ``stop=False`` kills them at once (a broken
        message stream). Idempotent."""
        if self._closed:
            return
        self._closed = True
        pending = []
        if stop and self._pg is not None:
            for i, p in enumerate(self._procs):
                if p.poll() is None:
                    try:
                        pending.append(_post(self._pg, i + 1,
                                             {"op": "stop"}, []))
                    except Exception:       # node already gone
                        pass
        reap(self._procs, JOIN_TIMEOUT_S if pending else 0.0)
        self._pg = None
        self._finalizer.detach()


# ---------------------------------------------------------------------------
# the memory node's side
# ---------------------------------------------------------------------------

class MemoryNode:
    """What one node process holds and serves, on its device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.objects: Dict[str, List[torch.Tensor]] = {}
        self.searches = 0
        self.gathers = 0

    def handle(self, meta: dict, tensors: List[torch.Tensor]
               ) -> Tuple[dict, List[torch.Tensor]]:
        op = meta["op"]
        if op == "place":
            self.objects[meta["name"]] = [t.to(self.device) for t in tensors]
            return {}, []
        if op == "drop":
            for name in meta["names"]:
                self.objects.pop(name, None)
            return {}, []
        if op == "search":
            return {}, list(self.search(meta, tensors[0]))
        if op == "gather":
            return {}, [self.gather(meta, tensors[0])]
        if op == "stats":
            return self.stats(), []
        if op == "reset":
            from repro_torch.kernels import _build
            _build.reset_launches()
            self.searches = self.gathers = 0
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            return {}, []
        raise ValueError(f"unknown fabric op {op!r}")

    @torch.no_grad()
    def search(self, meta: dict, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's per-node body: probe, take this node's probe
        columns under a probe split, scan this node's shard for the
        top-kk. Returns host (dists [nq, kk], ids [nq, kk])."""
        from repro_torch.core.chamvs import ChamVSConfig, shard_search
        from repro_torch.core.ivfpq import (IVFPQConfig, IVFPQParams,
                                            IVFPQShard)
        from repro_torch.kernels.ivf_scan.ops import ivf_index_scan

        fields = dict(meta["cfg"])
        cfg = ChamVSConfig(ivfpq=IVFPQConfig(**fields.pop("ivfpq")),
                           **fields)
        params = IVFPQParams(*self.objects[meta["params"]])
        shard = IVFPQShard(*self.objects[meta["shard"]])
        q = queries.to(self.device)
        _, probe_ids = ivf_index_scan(q, params.coarse_centroids, cfg.nprobe)
        if meta.get("probe") is not None:
            lo, n = meta["probe"]
            probe_ids = probe_ids[:, lo:lo + n].contiguous()
        d, i = shard_search(params, shard, q, probe_ids, cfg, meta["kk"])
        self.searches += 1
        return d.cpu(), i.cpu()

    @torch.no_grad()
    def gather(self, meta: dict, ids: torch.Tensor) -> torch.Tensor:
        """Rows of this node's table slice (global rows ``lo`` onward)
        for the ids that fall in it; 0 for every other id."""
        table = self.objects[meta["table"]][0]
        nloc = table.shape[0]
        rel = ids.to(self.device).long() - meta["lo"]
        hit = (rel >= 0) & (rel < nloc)
        vals = table[rel.clamp(0, nloc - 1)]
        mask = hit.reshape(hit.shape + (1,) * (vals.ndim - hit.ndim))
        self.gathers += 1
        return torch.where(mask, vals, torch.zeros_like(vals)).cpu()

    def stats(self) -> dict:
        from repro_torch.kernels import _build
        out = dict(pid=os.getpid(), device=str(self.device),
                   searches=self.searches, gathers=self.gathers,
                   objects=len(self.objects),
                   launches={n: k.launches
                             for n, k in _build.kernels().items()})
        if self.device.type == "cuda":
            out.update(device_name=torch.cuda.get_device_name(self.device),
                       peak_bytes=torch.cuda.max_memory_allocated(
                           self.device),
                       held_bytes=torch.cuda.memory_allocated(self.device))
        else:
            out.update(device_name="cpu", peak_bytes=None, held_bytes=None)
        return out


def node_main(argv: Optional[Sequence[str]] = None) -> None:
    """A memory node's loop: receive, serve, reply, until ``stop`` or
    until the coordinator goes away."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    watch_parent(args.parent)
    torch.set_num_threads(NODE_THREADS)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if dev.index is None:               # "cuda": the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    store = dist.TCPStore(
        HOST, args.port, args.world, False,
        timeout=datetime.timedelta(seconds=START_TIMEOUT_S))
    store.set(f"ready/{args.rank}", "1")
    pg = dist.ProcessGroupGloo(store, args.rank, args.world,
                               datetime.timedelta(seconds=NODE_IDLE_S))
    node = MemoryNode(dev)
    inbox = torch.empty(MSG_BYTES, dtype=torch.uint8)
    head, work = _expect(pg, 0, inbox)
    while True:
        try:
            work.wait()
            meta, tensors, _ = _finish(pg, 0, head)
            head, work = _expect(pg, 0, inbox)  # ready for the next one
        except Exception:                   # the coordinator is gone
            os._exit(0)
        if meta["op"] == "stop":
            os._exit(0)
        t0 = time.perf_counter()
        try:
            out_meta, out = node.handle(meta, tensors)
            reply = dict(out_meta, ok=True)
        except BaseException:               # reported to the coordinator
            reply, out = {"ok": False, "error": traceback.format_exc()}, []
        reply["t"] = time.perf_counter() - t0
        try:
            works, _bufs, _ = _post(pg, 0, reply, out)
            for w in works:
                w.wait()
        except Exception:
            os._exit(0)


if __name__ == "__main__":
    node_main()
