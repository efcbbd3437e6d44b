"""``repro_torch.obs`` — the observability plane (twin of ``repro.obs``,
stdlib only):

  * ``trace`` — a ``Tracer`` with a zero-cost-when-disabled span API,
    thread-safe ring-buffered events and Chrome trace-event JSON export
    loadable in Perfetto (https://ui.perfetto.dev);
  * ``metrics`` — a ``MetricsRegistry`` (counters, gauges, fixed-bucket
    histograms with reservoir p50/p95/p99) rendered in Prometheus text
    exposition format;
  * ``adapters`` — ``bind_engine_metrics``: collectors that absorb the
    engine's stats (``PoolStats``, ``RetrievalStats``, the scheduler's
    straggler count) into one registry.

On the GPU, spans are host wall time (see ``trace``).
"""
from repro_torch.obs.adapters import bind_engine_metrics
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, Reservoir)
from repro_torch.obs.trace import NULL_TRACER, Tracer, validate_chrome_trace

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "Reservoir", "Tracer", "validate_chrome_trace",
    "bind_engine_metrics",
]
