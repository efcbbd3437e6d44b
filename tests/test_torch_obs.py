"""The port's observability plane (``repro_torch.obs``) against the
reference's ``repro.obs``, replayed from ``tests/test_obs.py``.

Both packages are stdlib-only here, so the claims are exact:

  * a ``Reservoir`` fed the same stream with the same seed holds the
    same sample (the retrieval hedge delay is a quantile of one);
  * histograms follow Prometheus bucket semantics, and a registry with
    the same series renders the same exposition text and snapshot;
  * the tracer nests, bounds its ring, is thread-safe, is silent when
    disabled, and its export passes ``validate_chrome_trace``; the two
    validators agree on good and malformed documents;
  * ``StageStat`` percentiles and the ``qps`` active window equal the
    reference's on the same events and clock.
"""
import random
import re
import threading
import tracemalloc

import pytest

from repro.obs import Histogram as JaxHistogram
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import Reservoir as JaxReservoir
from repro.obs import validate_chrome_trace as jax_validate
from repro.retrieval.stats import RetrievalStats as JaxStats
from repro.retrieval.stats import StageStat as JaxStageStat
from repro_torch.obs import (DEFAULT_BUCKETS, Histogram, MetricsRegistry,
                             Reservoir, Tracer, validate_chrome_trace)
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from repro_torch.retrieval.stats import RetrievalStats, StageStat


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _stream(n, seed):
    rng = random.Random(seed + 1000)
    return [rng.expovariate(50.0) for _ in range(n)]


# ---------------------------------------------------------------------------
# metrics: reservoir, histograms, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,seed,n", [(16, 0, 1000), (512, 0, 5000),
                                        (1024, 7, 3000), (8, 3, 5)])
def test_reservoir_sample_equals_reference(cap, seed, n):
    """Algorithm R with ``random.Random(seed)``: the same stream leaves
    the same sample, and so the same quantiles, in both packages."""
    ours, ref = Reservoir(cap=cap, seed=seed), JaxReservoir(cap=cap, seed=seed)
    for v in _stream(n, seed):
        ours.add(v)
        ref.add(v)
    assert ours._values == ref._values
    assert len(ours) == len(ref) == min(cap, n) and ours.n == ref.n == n
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)


def test_reservoir_bounded_and_uniform():
    r = Reservoir(cap=256)
    for i in range(10_000):
        r.add(float(i))
    assert len(r) == 256 and r.n == 10_000
    assert 3000 < r.quantile(0.5) < 7000
    assert Reservoir().quantile(0.5) == 0.0


def test_histogram_bucket_math():
    h = Histogram("t_seconds", "test", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 1.0, 7.0, 99.0):
        h.observe(v)
    lines = h.render()
    # le is an INCLUSIVE upper bound: 0.1 counts in le="0.1"
    assert 't_seconds_bucket{le="0.1"} 2' in lines
    assert 't_seconds_bucket{le="1"} 4' in lines
    assert 't_seconds_bucket{le="10"} 5' in lines
    assert 't_seconds_bucket{le="+Inf"} 6' in lines
    assert "t_seconds_count 6" in lines
    assert h.count == 6 and h.sum == pytest.approx(107.65)
    ref = JaxHistogram("t_seconds", "test", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 1.0, 7.0, 99.0):
        ref.observe(v)
    assert lines == ref.render() and h.snapshot() == ref.snapshot()


def test_histogram_quantiles_track_distribution():
    h = Histogram("q_seconds", buckets=DEFAULT_BUCKETS)
    for i in range(1, 1001):
        h.observe(i / 1000.0)
    assert h.quantile(0.50) == pytest.approx(0.5, abs=0.01)
    assert h.quantile(0.99) == pytest.approx(0.99, abs=0.01)
    snap = h.snapshot()
    assert snap["p50"] == pytest.approx(0.5, abs=0.01)
    assert snap["p99"] == pytest.approx(0.99, abs=0.01)


_LV = r'"(?:[^"\\\n]|\\.)*"'
SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*=' + _LV +
    r'(,[a-zA-Z_][a-zA-Z0-9_]*=' + _LV + r')*\})?'
    r' (-?\d+(\.\d+)?([eE][-+]?\d+)?|[+-]Inf|NaN)$')


def _populate(reg):
    """The same series on either package's registry."""
    c = reg.counter("ralm_reqs_total", "requests")
    c.inc(3, labels={"tenant": "a"})
    c.inc(1, labels={"tenant": 'quo"te\n'})
    reg.gauge("ralm_depth", "queue depth").set(5)
    reg.gauge("ralm_frac", "a fraction").set(0.125, labels={"x": "y"})
    h = reg.histogram("ralm_lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in _stream(300, 5):
        h.observe(v)
    reg.counter("ralm_empty_total", "never incremented")
    reg.counter("ralm_abs_total", "absorbed").set_total(17)
    return reg


def test_registry_exposition_identical_to_reference():
    text = _populate(MetricsRegistry()).render()
    assert text == _populate(JaxRegistry()).render()
    typed, seen = [], []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            typed.append(line.split()[2])
        elif line and not line.startswith("#"):
            assert SAMPLE_RE.match(line), f"bad sample line: {line!r}"
            seen.append(line.rsplit(" ", 1)[0])
    assert len(typed) == len(set(typed)) and len(seen) == len(set(seen))
    assert "ralm_lat_seconds_p99" in typed
    assert 'ralm_reqs_total{tenant="a"} 3' in text.splitlines()


def test_registry_snapshot_identical_to_reference():
    assert _populate(MetricsRegistry()).snapshot() == \
        _populate(JaxRegistry()).snapshot()


def test_registry_idempotent_and_kind_clash():
    reg = MetricsRegistry()
    a = reg.counter("x_total")
    assert reg.counter("x_total") is a
    reg.histogram("h_seconds")
    with pytest.raises(TypeError):
        reg.gauge("h_seconds")
    hits = []
    reg.register_collector(lambda: hits.append(1))
    assert not hits
    reg.render()
    reg.snapshot()
    assert len(hits) == 2


def test_counter_snapshot_shapes():
    reg = MetricsRegistry()
    reg.counter("plain_total").inc(2)
    assert reg.snapshot()["plain_total"] == 2.0
    reg.counter("lab_total").inc(1, labels={"op": "scan"})
    assert reg.snapshot()["lab_total"] == {'{op="scan"}': 1.0}


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_span_nesting_and_export():
    clock = FakeClock(5.0)
    tr = Tracer(clock=clock)
    with tr.span("outer", "wave", args={"rows": 2}):
        clock.t += 0.1
        with tr.span("inner", "wave"):
            clock.t += 0.2
        clock.t += 0.1
    doc = tr.export()
    assert doc["displayTimeUnit"] == "ms"
    assert validate_chrome_trace(doc) == [] and jax_validate(doc) == []
    by_name = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["args"] == {"rows": 2}
    assert outer["ts"] == pytest.approx(0.0)
    assert outer["dur"] == pytest.approx(0.4e6)
    assert inner["ts"] == pytest.approx(0.1e6)
    assert inner["dur"] == pytest.approx(0.2e6)
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(meta) == 1 and meta[0]["args"]["name"] == "wave"
    assert outer["tid"] == inner["tid"] == meta[0]["tid"]


def test_instant_flow_and_retroactive_complete():
    clock = FakeClock(5.0)
    tr = Tracer(clock=clock)
    clock.t = 6.0
    tr.instant("kvpool.alloc", "kvpool", args={"rows": 2})
    tr.flow_start(42, t_s=5.5)
    tr.flow_end(42, track="wave", t_s=6.0)
    tr.complete("queue.wait", "requests", t0_s=5.25, dur_s=0.5)
    tr.complete("clamped", "requests", t0_s=6.0, dur_s=-1.0)
    assert validate_chrome_trace(tr.export()) == []
    evs = {e["name"]: e for e in tr.events() if e["ph"] != "M"}
    assert evs["kvpool.alloc"]["ph"] == "i"
    assert evs["kvpool.alloc"]["ts"] == pytest.approx(1.0e6)
    assert evs["queue.wait"]["ts"] == pytest.approx(0.25e6)
    assert evs["queue.wait"]["dur"] == pytest.approx(0.5e6)
    assert evs["clamped"]["dur"] == 0.0
    flows = [e for e in tr.events() if e.get("cat") == "flow"]
    assert [e["ph"] for e in flows] == ["s", "f"]
    assert flows[1]["bp"] == "e"


def test_ring_buffer_bounded():
    tr = Tracer(capacity=16)
    for i in range(100):
        tr.instant(f"e{i}", "t")
    evs = tr.events()
    assert len(evs) == 16 and evs[-1]["name"] == "e99"


def test_clear_reemits_track_metadata():
    tr = Tracer()
    with tr.span("a", "wave"):
        pass
    with tr.span("b", "retrieval"):
        pass
    tr.clear()
    assert all(e["ph"] == "M" for e in tr.events())
    assert {e["args"]["name"] for e in tr.events()} == {"wave", "retrieval"}
    with tr.span("after", "wave"):
        pass
    assert validate_chrome_trace(tr.export()) == []


def test_tracer_thread_safety():
    tr = Tracer(capacity=1 << 15)
    nthreads, per = 8, 200

    def worker(i):
        track = f"t{i % 4}"
        for _ in range(per):
            with tr.span(f"s{i}", track):
                pass
            tr.instant(f"i{i}", track)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = tr.events()
    assert len(evs) == 4 + 2 * per * nthreads
    assert validate_chrome_trace(tr.export()) == []
    assert len({e["tid"] for e in evs}) == 4


def test_disabled_tracer_is_null_and_allocates_nothing():
    from repro_torch.obs import trace as trace_mod
    tr = Tracer(enabled=False)
    s1, s2 = tr.span("a", args={"x": 1}), tr.span("b")
    assert s1 is s2 is NULL_SPAN
    tr.instant("i")
    tr.complete("c", "t", 0.0, 1.0)
    tr.flow_start(1)
    tr.flow_end(1)
    assert tr.events() == [] and NULL_TRACER.events() == []

    def hot_loop(n):
        for _ in range(n):
            with tr.span("hot", "wave"):
                pass
            tr.instant("hot", "wave")

    tracemalloc.start()
    hot_loop(2000)
    before = tracemalloc.take_snapshot()
    hot_loop(2000)
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    filt = [tracemalloc.Filter(True, trace_mod.__file__)]
    diff = after.filter_traces(filt).compare_to(
        before.filter_traces(filt), "lineno")
    assert sum(d.size_diff for d in diff) <= 0


def test_validator_agrees_with_reference():
    base = {"pid": 1, "tid": 1, "ts": 0.0, "name": "e"}
    s = {**base, "ph": "s", "id": 9}
    f = {**base, "ph": "f", "id": 9}
    bad = [{"nope": 1}, "text", [1, 2], [{**base, "ph": "Q"}],
           [{**base, "ph": "X"}], [{**base, "ph": "X", "dur": -5}],
           [{"ph": "i", "ts": 0.0}], [s], [f]]
    good = [[s, f], [{**base, "ph": "i"}],
            {"traceEvents": [{**base, "ph": "X", "dur": 1.0}]}]
    for doc in bad:
        assert validate_chrome_trace(doc) == jax_validate(doc) != []
    for doc in good:
        assert validate_chrome_trace(doc) == jax_validate(doc) == []


# ---------------------------------------------------------------------------
# the retrieval stats' percentiles and rate
# ---------------------------------------------------------------------------

def test_stagestat_percentiles_equal_reference():
    st, ref = StageStat(), JaxStageStat()
    for v in _stream(2000, 9):
        st.add(v)
        ref.add(v)
    assert st.summary() == ref.summary()
    lin = StageStat()
    for i in range(1, 101):
        lin.add(i * 1e-3)
    s = lin.summary()
    assert s["p50_us"] == pytest.approx(51_000, rel=0.05)
    assert s["p99_us"] == pytest.approx(100_000, rel=0.02)
    assert s["count"] == 100


def test_retrieval_stats_qps_active_window():
    """Bursts separated by idle time report the rate within the bursts,
    as the reference does on the same clock."""
    outs = []
    for cls in (RetrievalStats, JaxStats):
        clock = FakeClock()
        st = cls(clock=clock)
        assert st.qps() == 0.0
        st.record_submit(8)
        clock.t = 0.1
        st.record_batch(8)
        clock.t = 100.0
        st.record_submit(8)
        clock.t = 100.1
        st.record_batch(8)
        outs.append(st.qps())
    assert outs[0] == outs[1] == pytest.approx(16 / 1.2)


def test_retrieval_stats_qps_single_instant():
    clock = FakeClock(10.0)
    st = RetrievalStats(clock=clock)
    st.record_submit(5)
    clock.t = 10.25
    assert st.qps() == pytest.approx(20.0)
    clock.t = 500.0
    assert st.qps() == pytest.approx(5.0)


def test_snapshot_keys_equal_reference():
    """The snapshot, the ``fault`` dict included, has the reference's
    keys and values on the same events."""
    snaps = []
    for cls in (RetrievalStats, JaxStats):
        st = cls(clock=FakeClock(1.0))
        st.record_submit(4)
        st.record_batch(4, dispatches=2)
        st.ft_hedges, st.ft_partial_rows = 3, 4
        st.ft_dispatch.add(0.002)
        snaps.append(st.snapshot())
    ours, ref = snaps
    assert ours == ref
    assert set(ours["fault"]) == {
        "timeouts", "hedges", "retries", "crashes", "ejections",
        "recoveries", "partial_flushes", "partial_rows", "spec_flushed",
        "dispatch"}
