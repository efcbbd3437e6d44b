"""Tracing: ring-buffered spans exported as Chrome trace events,
loadable in Perfetto (twin of ``repro.obs.trace``, stdlib only).

On the GPU a span is host wall time: it covers the device work inside
it only where that code waits for the card (the retrieval flush with
the fault-tolerant layer armed or ``measure`` on); elsewhere it times
the enqueue.

Design constraints, in priority order:

  1. **Zero cost when disabled.** The serving hot path (one scheduler
     wave per generated token) cannot afford allocations for telemetry
     nobody asked for. A disabled tracer's ``span()`` returns one
     process-wide ``_NullSpan`` singleton — no span object, no event
     dict, no timestamp read — and the instrumentation sites build
     their ``args`` dicts only behind an ``if tracer.enabled`` guard.
     The port's obs tests pin this with tracemalloc.
  2. **Thread-safe, bounded, never blocking.** Events land in a
     ``collections.deque(maxlen=capacity)`` — appends are atomic under
     the GIL, old events fall off the back instead of growing without
     bound, and nothing on the recording path takes a lock (only track
     registration does, once per track name).
  3. **A standard viewer, not a bespoke one.** Export is the Chrome
     trace-event JSON format (``{"traceEvents": [...]}``): open the
     file at https://ui.perfetto.dev or chrome://tracing. Wave-level
     spans share one named track, retrieval stages another, and
     per-request *flow events* (``ph: "s"`` / ``"f"``) draw the TTFT
     arrow from a request's queue-wait slice to the wave that emitted
     its first token — across tracks.

Event vocabulary used here (all timestamps in microseconds since the
tracer's origin):

  ===  =========================================================
  ph   meaning
  ===  =========================================================
  X    complete span (``ts`` + ``dur``) — what ``span()`` records
  i    instant event (alloc/release, degrade transition, recompile)
  s/f  flow start / finish, paired by ``id`` (the request trace id)
  M    metadata (track names — one ``thread_name`` per track)
  ===  =========================================================
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Union

__all__ = ["Tracer", "NULL_TRACER", "validate_chrome_trace"]


class _NullSpan:
    """The do-nothing context manager a disabled tracer hands out.
    One module-level instance; identity is asserted by the overhead
    guard test."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """A live span: times its ``with`` body, records one ``X`` event."""
    __slots__ = ("_tracer", "name", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, tid: int,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.tid = tid
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        t1 = tr._clock()
        ev = {"name": self.name, "ph": "X", "pid": tr.pid,
              "tid": self.tid, "ts": (self._t0 - tr._origin) * 1e6,
              "dur": (t1 - self._t0) * 1e6}
        if self.args:
            ev["args"] = self.args
        tr._events.append(ev)
        return False


class Tracer:
    """Ring-buffered trace recorder with named tracks.

    ``enabled`` is the master switch: every recording method returns
    immediately (span: the null singleton) when it is False, so a
    deployment can keep the instrumentation compiled in and pay only an
    attribute check per wave. Tracks are logical lanes in the viewer
    ("wave", "retrieval", "requests", ...) mapped to stable ``tid``
    integers, each announced once with a ``thread_name`` metadata
    event."""

    def __init__(self, enabled: bool = True, capacity: int = 1 << 16,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.capacity = capacity
        self._clock = clock
        self._origin = clock()
        self.pid = os.getpid()
        self._events: deque = deque(maxlen=capacity)
        self._tracks: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- track bookkeeping --------------------------------------------------

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.get(track)
                if tid is None:
                    tid = len(self._tracks) + 1
                    self._tracks[track] = tid
                    self._events.append(
                        {"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid, "ts": 0,
                         "args": {"name": track}})
        return tid

    def _ts(self, t_s: Optional[float] = None) -> float:
        """Clock seconds -> trace microseconds (now when ``t_s`` None)."""
        t = self._clock() if t_s is None else t_s
        return (t - self._origin) * 1e6

    # -- recording ----------------------------------------------------------

    def span(self, name: str, track: str = "engine",
             args: Optional[dict] = None) -> Union[_Span, _NullSpan]:
        """``with tracer.span("retrieval.scan", "retrieval"): ...`` —
        records one complete event around the body. Returns the null
        singleton when disabled; pass ``args`` only behind an
        ``if tracer.enabled`` guard on hot paths (the dict literal is
        the allocation, not this call)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, self._tid(track), args)

    def instant(self, name: str, track: str = "engine",
                args: Optional[dict] = None) -> None:
        """Point event (thread-scoped): alloc/release, transitions."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self.pid,
              "tid": self._tid(track), "ts": self._ts()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def complete(self, name: str, track: str, t0_s: float, dur_s: float,
                 args: Optional[dict] = None) -> None:
        """Retroactive span from explicit clock timestamps — for
        intervals whose start predates the recording site (queue wait:
        the flush knows when the oldest row was submitted)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "pid": self.pid,
              "tid": self._tid(track), "ts": self._ts(t0_s),
              "dur": max(0.0, dur_s) * 1e6}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def flow_start(self, flow_id: int, name: str = "request",
                   track: str = "requests",
                   t_s: Optional[float] = None) -> None:
        """Open a flow arrow (pairs with ``flow_end`` on any track)."""
        if not self.enabled:
            return
        self._events.append(
            {"name": name, "cat": "flow", "ph": "s", "id": int(flow_id),
             "pid": self.pid, "tid": self._tid(track),
             "ts": self._ts(t_s)})

    def flow_end(self, flow_id: int, name: str = "request",
                 track: str = "requests",
                 t_s: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self._events.append(
            {"name": name, "cat": "flow", "ph": "f", "bp": "e",
             "id": int(flow_id), "pid": self.pid,
             "tid": self._tid(track), "ts": self._ts(t_s)})

    # -- export -------------------------------------------------------------

    def events(self) -> List[dict]:
        """Snapshot of the ring buffer (oldest first)."""
        return list(self._events)

    def clear(self) -> None:
        """Drop buffered events (a capture boundary). Track metadata is
        re-emitted so an export after ``clear()`` remains
        self-contained."""
        with self._lock:
            fresh: deque = deque(maxlen=self.capacity)
            for track, tid in self._tracks.items():
                fresh.append(
                    {"name": "thread_name", "ph": "M", "pid": self.pid,
                     "tid": tid, "ts": 0, "args": {"name": track}})
            self._events = fresh

    def export(self) -> dict:
        """The Chrome trace-event document (open in Perfetto)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


#: the shared disabled tracer every component defaults to — one
#: attribute check (`tracer.enabled`) is the entire disabled-path cost
NULL_TRACER = Tracer(enabled=False, capacity=1)


# ---------------------------------------------------------------------------
# schema validation (tests + the smoke's trace check)
# ---------------------------------------------------------------------------

_REQUIRED = ("ph", "ts", "pid", "tid")
_KNOWN_PH = {"X", "B", "E", "i", "I", "s", "t", "f", "M", "C"}


def validate_chrome_trace(doc: Union[dict, list]) -> List[str]:
    """Check a trace document against the Chrome trace-event contract
    this repo relies on. Returns a list of problems (empty == valid):

      * the document is ``{"traceEvents": [...]}`` (or a bare list);
      * every event carries ``ph``/``ts``/``pid``/``tid`` and a string
        ``name``, with a known phase;
      * ``X`` events have a non-negative numeric ``dur``;
      * flow events pair up — every ``ph:"s"`` id has a matching
        ``ph:"f"`` and vice versa (an unpaired flow renders as an arrow
        into nowhere)."""
    problems: List[str] = []
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["document has no 'traceEvents' list"]
    elif isinstance(doc, list):
        events = doc
    else:
        return [f"document must be dict or list, got {type(doc).__name__}"]

    flow_s: Dict[int, int] = {}
    flow_f: Dict[int, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in _REQUIRED:
            if key not in ev:
                problems.append(f"event {i} ({ev.get('name')!r}): "
                                f"missing {key!r}")
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing/non-string name")
        ph = ev.get("ph")
        if ph is not None and ph not in _KNOWN_PH:
            problems.append(f"event {i}: unknown phase {ph!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev.get('name')!r}): X event "
                                f"needs dur >= 0, got {dur!r}")
        if ph in ("s", "f"):
            if "id" not in ev:
                problems.append(f"event {i}: flow event missing id")
            else:
                side = flow_s if ph == "s" else flow_f
                side[ev["id"]] = side.get(ev["id"], 0) + 1
    for fid, n in flow_s.items():
        if flow_f.get(fid, 0) != n:
            problems.append(
                f"flow id {fid}: {n} start(s) vs "
                f"{flow_f.get(fid, 0)} finish(es)")
    for fid, n in flow_f.items():
        if fid not in flow_s:
            problems.append(f"flow id {fid}: {n} finish(es) without start")
    return problems
