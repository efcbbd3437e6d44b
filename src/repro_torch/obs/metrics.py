"""Metrics: counters, gauges, fixed-bucket histograms with reservoir
percentiles, rendered as Prometheus text exposition (twin of
``repro.obs.metrics``, stdlib only, the same text for the same series).

A ``MetricsRegistry`` absorbs the port's scattered stats objects
(``PoolStats``, ``RetrievalStats``, the scheduler's straggler count —
see ``repro_torch.obs.adapters``) behind two read paths:

  * ``render()`` — Prometheus text format 0.0.4 (scrapeable by an
    actual Prometheus);
  * ``snapshot()`` — a plain nested dict of the same families.

Percentiles come from a bounded reservoir (Vitter's algorithm R) kept
alongside each histogram's fixed buckets: buckets give Prometheus its
cumulative ``le`` series for server-side quantile math, the reservoir
gives exact-ish p50/p95/p99 gauges without unbounded memory. The
reservoir's ``random.Random(seed)`` draws are the reference's, so the
same stream leaves the same sample in both packages — the retrieval
hedge delay is a quantile of such a sample. Collectors registered with
``register_collector`` run at scrape time, so gauge families always
reflect live engine state with zero hot-path cost.
"""
from __future__ import annotations

import random
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Reservoir", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS"]

#: latency buckets in seconds, spanning ~100us .. 30s — wide enough for
#: interpret-mode CI (slow) and compiled serving (fast) alike
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(x: float) -> str:
    if x == float("inf"):
        return "+Inf"
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return repr(float(x)) if isinstance(x, float) else str(x)


class Reservoir:
    """Bounded uniform sample of a stream (algorithm R).

    Keeps at most ``cap`` values; each of the ``n`` observed values has
    equal probability cap/n of being in the sample, so quantiles of the
    reservoir estimate quantiles of the full stream. The RNG is seeded
    per-instance for reproducible tests."""

    __slots__ = ("cap", "n", "_values", "_rng", "_sorted")

    def __init__(self, cap: int = 1024, seed: int = 0):
        self.cap = cap
        self.n = 0
        self._values: List[float] = []
        self._rng = random.Random(seed)
        self._sorted = True

    def add(self, value: float) -> None:
        self.n += 1
        if len(self._values) < self.cap:
            self._values.append(value)
            self._sorted = False
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self._values[j] = value
                self._sorted = False

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile of the sample; 0.0 when empty."""
        if not self._values:
            return 0.0
        if not self._sorted:
            self._values.sort()
            self._sorted = True
        idx = min(len(self._values) - 1,
                  max(0, int(q * len(self._values))))
        return self._values[idx]

    def __len__(self) -> int:
        return len(self._values)


class Counter:
    """Monotonic counter, optionally labelled. ``inc`` adds;
    ``set_total`` absorbs an externally-maintained running total (the
    adapter pattern — admission counters already count themselves)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, total: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(total)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> Iterable[Tuple[str, float]]:
        with self._lock:
            items = list(self._values.items())
        if not items:
            items = [((), 0.0)]
        for key, v in sorted(items):
            yield self.name + _render_labels(key), v

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        lines += [f"{s} {_fmt(v)}" for s, v in self.samples()]
        return lines

    def snapshot(self):
        with self._lock:
            if set(self._values) == {()}:
                return self._values[()]
            return {_render_labels(k) or "": v
                    for k, v in sorted(self._values.items())}


class Gauge(Counter):
    """A value that can go up and down (queue depth, degrade level)."""

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        self.set_total(value, labels)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        lines += [f"{s} {_fmt(v)}" for s, v in self.samples()]
        return lines


class Histogram:
    """Fixed-bucket histogram + reservoir percentiles.

    Renders the standard Prometheus cumulative ``_bucket{le=...}`` /
    ``_sum`` / ``_count`` series plus companion gauge families
    ``{name}_p50`` / ``_p95`` / ``_p99`` computed from the reservoir —
    bucket-interpolated quantiles are only as fine as the bucket grid,
    and latency percentiles need better than that."""

    QUANTILES = ((0.50, "p50"), (0.95, "p95"), (0.99, "p99"))

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 reservoir_cap: int = 1024):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._n = 0
        self.reservoir = Reservoir(cap=reservoir_cap)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        # bisect_left: a value equal to a bucket edge belongs IN that
        # bucket (Prometheus `le` is an inclusive upper bound)
        idx = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._n += 1
            self.reservoir.add(value)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        with self._lock:
            return self.reservoir.quantile(q)

    def render(self) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            total, tsum = self._n, self._sum
            quants = [(label, self.reservoir.quantile(q))
                      for q, label in self.QUANTILES]
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for edge, c in zip(self.buckets, counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(edge)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{self.name}_sum {_fmt(tsum)}")
        lines.append(f"{self.name}_count {total}")
        for label, v in quants:
            qname = f"{self.name}_{label}"
            lines.append(f"# HELP {qname} {label} of {self.name} "
                         f"(reservoir estimate)")
            lines.append(f"# TYPE {qname} gauge")
            lines.append(f"{qname} {_fmt(v)}")
        return lines

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self._n,
                "sum": self._sum,
                "p50": self.reservoir.quantile(0.50),
                "p95": self.reservoir.quantile(0.95),
                "p99": self.reservoir.quantile(0.99),
            }


class MetricsRegistry:
    """Named metric families + pull-at-scrape collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent by
    name, so adapters can bind repeatedly); ``register_collector`` adds
    a zero-arg callable run at the top of every ``render()``/
    ``snapshot()`` — the bridge that copies live engine state
    (pool stats, retrieval stats, fallback counts) into gauge families
    without instrumenting those hot paths."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._order: List[str] = []
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
                self._order.append(name)
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help, buckets), Histogram)

    def register_collector(self, fn: Callable[[], None]) -> None:
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def render(self) -> str:
        """Prometheus text exposition 0.0.4."""
        self.collect()
        lines: List[str] = []
        for name in list(self._order):
            lines += self._metrics[name].render()
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Plain-dict view of every family."""
        self.collect()
        return {name: self._metrics[name].snapshot()
                for name in list(self._order)}
