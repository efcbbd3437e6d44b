"""Reading the device trace of the profiled tail of a ``--trace 1`` window.

The tail is profiled in two halves (``harness.TracedTail``):

- CUDA activity alone (``device_summary``): every kernel, copy and set on
  the card, with the least host cost the profiler has. ``busy_s`` is the
  union of their intervals, ``window_s`` the half's host time between
  two synchronisations, ``by_kernel`` device seconds by name.
- CPU and CUDA activity with the harness's ``bench.<label>`` ranges
  around the engine's calls (``labelled_summary``): ``by_label`` is
  device seconds by the innermost range the host was in when it launched
  each event (the CUDA runtime call that shares the event's correlation
  id gives the launch's time: the port launches its own kernels through
  ``ctypes``, outside any aten op; else the op the event is linked to;
  ``other`` outside the ranges); ``idle`` is idle device seconds by the
  innermost range the host was in when each gap began (``scheduler``
  outside them: the scheduler's own loop and the harness). This half's
  host runs slower under the profiler, so its idle gaps are long.

CPU and device timestamps share the profiler's clock.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

import torch

# outer ranges first: an inner range overrides the one holding it
LABELS = ("admit", "decode", "search", "finish", "resolve", "mix")
PREFIX = "bench."


def start(cpu: bool) -> "torch.profiler.profile":
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


class _Ranges:
    """Sorted, non-overlapping ranges of one label."""

    def __init__(self, spans: List[Tuple[int, int]]):
        spans.sort()
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]


def _label(ranges: Dict[str, _Ranges], t: int, default: str) -> str:
    found = default
    for name in LABELS:
        r = ranges.get(name)
        if r is not None and r.holds(t):
            found = name
    return found


def _union(intervals: List[Tuple[int, int]]) -> int:
    busy, cursor = 0, None
    for s, e in sorted(intervals):
        if cursor is None or s > cursor:
            busy += e - s
            cursor = e
        elif e > cursor:
            busy += e - cursor
            cursor = e
    return busy


def device_summary(prof, window_s: float) -> dict:
    """The CUDA-only half: busy seconds and device seconds by name."""
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel: Dict[str, float] = {}
    intervals = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda or ev.name().startswith(PREFIX):
            continue
        s, e = ev.start_ns(), ev.end_ns()
        if e > s:
            intervals.append((s, e))
            by_kernel[ev.name()] = by_kernel.get(ev.name(), 0.0) + \
                (e - s) * 1e-9
    return dict(busy_s=_union(intervals) * 1e-9, window_s=window_s,
                by_kernel=by_kernel, device_events=len(intervals))


def labelled_summary(prof) -> dict:
    """The labelled half: device seconds and idle seconds by engine call."""
    prof.stop()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans: Dict[str, List[Tuple[int, int]]] = {}
    op_start: Dict[int, int] = {}            # frontend op -> host start
    rt_start: Dict[int, int] = {}            # runtime call -> host start
    device = []                      # (start, end, corr, linked)
    for ev in events:
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            if not name.startswith(PREFIX):  # not a range's device shadow
                device.append((start, end, ev.correlation_id(),
                               ev.linked_correlation_id()))
            continue
        if name.startswith(PREFIX):
            spans.setdefault(name[len(PREFIX):], []).append((start, end))
        if name.startswith("cu"):            # cudaLaunchKernel, cuLaunch...
            rt_start[ev.correlation_id()] = start
        elif ev.linked_correlation_id() == 0:    # a frontend op or range
            op_start[ev.correlation_id()] = start
    window = spans.pop("window", None)
    if not window:
        raise RuntimeError("profile: no bench.window range recorded")
    w0, w1 = min(s for s, _ in window), max(e for _, e in window)
    ranges = {name: _Ranges(s) for name, s in spans.items()}
    by_label: Dict[str, float] = {}
    clipped = []
    for start, end, corr, linked in device:
        s, e = max(start, w0), min(end, w1)
        if e <= s:
            continue
        launch = rt_start.get(corr, op_start.get(linked))
        label = "other" if launch is None else _label(ranges, launch, "other")
        by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-9
        clipped.append((s, e))
    clipped.sort()
    idle: Dict[str, float] = {}
    cursor = w0
    for s, e in clipped + [(w1, w1)]:
        if s > cursor:
            label = _label(ranges, cursor, "scheduler")
            idle[label] = idle.get(label, 0.0) + (s - cursor) * 1e-9
        cursor = max(cursor, e)
    return dict(by_label=by_label, idle=idle,
                labelled_window_s=(w1 - w0) * 1e-9,
                labelled_busy_s=_union(clipped) * 1e-9)


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    parameter list, at most ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


def breakdown(summary: dict) -> dict:
    """The ten device ops that took most time (by kernel name, without
    its parameters) and the ten largest idle shares by what the host was
    doing, [name, seconds] each."""
    by_name: Dict[str, float] = {}
    for name, sec in summary["by_kernel"].items():
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"idle while host in {n}", s] for n, s in idle]}
