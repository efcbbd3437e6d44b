"""The port's engine under injected retrieval faults, replayed against
the JAX engine (from ``tests/test_chaos.py`` and
``tests/test_fault_tolerance.py``).

The ``tiny_ralm`` recipe (a reduced Dec-S LM, vocab 64, over a
deterministic-bigram corpus, two shards = two fault domains) is built
by the reference and converted leaf for leaf. Each replay runs the same
requests through the port's engine and the JAX engine under the same
``FaultPlan``: greedy tokens, ``partial_steps`` and the ``ft_*``
counters must be equal. The cases: the seed matrix (hang / crash / slow
on one replica: tokens equal the fault-free run's), a shard outage
that degrades and recovers, speculation surviving partial results, the
wave straggler watchdog and ``StragglerMonitor``, the ``fault`` metrics
family, ``EngineConfig`` arming the layer (and refusing it without
async retrieval), and the tracer through a real wave.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import transformer as jtf
from repro.retrieval import FailoverConfig as JaxFailover
from repro.retrieval import FaultPlan as JaxPlan
from repro.retrieval import ServiceConfig as JaxServiceConfig
from repro.runtime.fault_tolerance import StragglerMonitor as JaxMonitor
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro_torch import convert
from repro_torch.obs import (MetricsRegistry, Tracer, bind_engine_metrics,
                             validate_chrome_trace)
from repro_torch.retrieval import (FailoverConfig, FaultPlan, FaultSpec,
                                   ServiceConfig, crash_plan)
from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.serve import (EngineConfig, RagConfig, RalmEngine,
                               RalmRequest)

FT_COUNTERS = ("ft_timeouts", "ft_hedges", "ft_retries", "ft_crashes",
               "ft_ejections", "ft_recoveries", "ft_partial_flushes",
               "ft_partial_rows", "ft_spec_flushed")
SPEC_COUNTERS = ("spec_issued", "spec_verified", "spec_accepted",
                 "spec_rollbacks", "spec_discarded", "spec_replayed_steps")
NO_COMEBACK = dict(replicas=2, probation_s=999.0)
HEALING = dict(replicas=2, probation_s=0.0, probation_successes=1,
               probe_every=2)


@pytest.fixture(scope="module")
def tiny_ralm():
    cfg = dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    corpus = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        corpus.append((3 * corpus[-1] + 1) % 64)
    corpus = np.stack(corpus, axis=1).astype(np.int32)
    ds = JaxBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512,
                    num_shards=2).from_corpus(params, cfg, corpus)
    rag = JaxRagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                       temperature=1.0)
    tcfg = convert.model_config(dataclasses.asdict(cfg))
    tparams = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), params),
        tcfg)
    tds = convert.datastore(
        dataclasses.asdict(ds.index_cfg), np.array(ds.params.coarse_centroids),
        np.array(ds.params.codebooks),
        [(np.array(s.codes), np.array(s.ids), np.array(s.list_len))
         for s in ds.shards],
        payload_tokens=np.array(ds.payload_tokens),
        num_vectors=ds.num_vectors)
    return dict(cfg=cfg, params=params, corpus=corpus, ds=ds, rag=rag,
                tcfg=tcfg, tparams=tparams, tds=tds)


def _engines(t, failover=None, plan=None, spec_k=0):
    """The port's engine and the JAX engine over async retrievers with
    the same failover knobs and chaos plan."""
    jret = t["ds"].async_retriever(
        t["ds"].search_config(nprobe=4, k=8, backend="ref"),
        service_cfg=JaxServiceConfig(
            measure=False,
            failover=None if failover is None else JaxFailover(**failover)))
    tret = t["tds"].async_retriever(
        t["tds"].search_config(nprobe=4, k=8),
        service_cfg=ServiceConfig(
            measure=False,
            failover=None if failover is None else FailoverConfig(**failover)))
    if plan is not None:
        tret.service.install_chaos(plan)
        jret.service.install_chaos(JaxPlan.from_json(plan.to_json()))
    jeng = JaxEngine.monolithic(t["params"], t["cfg"], t["rag"],
                                retriever=jret, speculate_k=spec_k)
    teng = RalmEngine.monolithic(t["tparams"], t["tcfg"],
                                 RagConfig(**dataclasses.asdict(t["rag"])),
                                 retriever=tret, speculate_k=spec_k)
    return teng, jeng


def _serve(eng, corpus, n=2, steps=8, sequential=False):
    """Submit ``n`` two-row requests (all at once, or one after another
    when ``sequential``) and return the responses in submission order."""
    jax_engine = isinstance(eng, JaxEngine)
    req, conv = ((JaxRequest, jnp.asarray) if jax_engine
                 else (RalmRequest, torch.from_numpy))
    done, rids = [], []
    for i in range(n):
        rids.append(eng.submit(req(prompt=conv(corpus[2 * i:2 * i + 2, :4]),
                                   steps=steps)))
        if sequential:
            done += eng.run()
    done += eng.run()
    by_id = {r.request_id: r for r in done}
    return [by_id[r] for r in rids]


def _counters(eng, names):
    st = eng.retriever.service.stats
    return {k: getattr(st, k) for k in names}


def _assert_same(out, jout):
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))
        assert a.partial_steps == b.partial_steps


@pytest.mark.parametrize("kind,seed", [("hang", 0), ("crash", 0),
                                       ("slow", 7)])
def test_chaos_seed_matrix_token_parity(tiny_ralm, kind, seed):
    """Replica-level faults (the sibling always covers) are invisible in
    the tokens: equal to the fault-free run's and to the JAX engine's
    under the same plan, no partial step, equal fault counters."""
    corpus = tiny_ralm["corpus"]
    base = _serve(_engines(tiny_ralm)[0], corpus)
    plan = FaultPlan.make(
        [FaultSpec(kind=kind, replica=1, start_flush=2,
                   p=0.5 if kind == "slow" else 1.0,
                   slow_s=0.001 if kind == "slow" else 0.0)], seed=seed)
    teng, jeng = _engines(tiny_ralm, failover=NO_COMEBACK, plan=plan)
    out, jout = _serve(teng, corpus), _serve(jeng, corpus)
    _assert_same(out, jout)
    _assert_same(out, base)
    assert all(r.partial_steps == 0 for r in out)
    assert _counters(teng, FT_COUNTERS) == _counters(jeng, FT_COUNTERS)
    st = teng.retriever.service.stats
    assert st.ft_partial_flushes == 0
    if kind != "slow":
        assert getattr(st, {"hang": "ft_hedges",
                            "crash": "ft_crashes"}[kind]) >= 1
    assert teng.retriever.service.chaos.counts() == \
        jeng.retriever.service.chaos.counts()


def test_shard_outage_degrades_and_recovers_tokens(tiny_ralm):
    """A whole domain down for flushes 4-12 (sequential requests, so the
    window maps onto requests): every request completes, the affected
    steps are counted per request, the last request (after the window)
    returns to the fault-free tokens — all as in the JAX engine."""
    corpus = tiny_ralm["corpus"]
    base = _serve(_engines(tiny_ralm)[0], corpus, n=3, sequential=True)
    plan = FaultPlan.make(
        [FaultSpec(kind="crash", shard=0, start_flush=4, stop_flush=12)])
    teng, jeng = _engines(tiny_ralm, failover=HEALING, plan=plan)
    out = _serve(teng, corpus, n=3, sequential=True)
    jout = _serve(jeng, corpus, n=3, sequential=True)
    assert len(out) == 3
    _assert_same(out, jout)
    st = teng.retriever.service.stats
    assert st.ft_partial_flushes > 0
    assert sum(r.partial_steps for r in out) == st.ft_partial_flushes
    assert out[0].partial_steps > 0 and out[-1].partial_steps == 0
    assert st.ft_recoveries >= 1
    assert _counters(teng, FT_COUNTERS) == _counters(jeng, FT_COUNTERS)
    np.testing.assert_array_equal(out[-1].tokens, base[-1].tokens)


def test_speculation_survives_partial_results(tiny_ralm):
    """A partial handle at harvest settles without seeding the next
    point, every point settles, nothing wedges — with the JAX engine's
    tokens and speculation and fault counters."""
    corpus = tiny_ralm["corpus"]
    plan = FaultPlan.make(
        [FaultSpec(kind="crash", shard=0, start_flush=3, stop_flush=9)])
    teng, jeng = _engines(tiny_ralm, failover=HEALING, plan=plan, spec_k=1)
    out = _serve(teng, corpus, n=2, steps=10)
    jout = _serve(jeng, corpus, n=2, steps=10)
    _assert_same(out, jout)
    st = teng.retriever.service.stats
    assert st.ft_partial_flushes > 0 and st.spec_issued > 0
    assert st.spec_accepted + st.spec_rollbacks == st.spec_verified
    assert _counters(teng, SPEC_COUNTERS + FT_COUNTERS) == \
        _counters(jeng, SPEC_COUNTERS + FT_COUNTERS)
    assert teng.retriever.service.num_inflight == 0
    assert teng.pool.num_used == 0


def test_wave_straggler_watchdog(tiny_ralm):
    """The scheduler feeds each wave's wall time to a StragglerMonitor:
    an outlier wave bumps the counter and drops a trace instant; the
    first waves are never flagged, and a real run counts its waves."""
    teng, jeng = _engines(tiny_ralm)
    teng.set_tracer(Tracer())
    for sched in (teng.scheduler, jeng.scheduler):
        for _ in range(6):
            sched._record_wave(0.010)
        assert sched.straggler_events == 0
        sched._record_wave(0.100)
        assert sched.straggler_events == 1
        sched._record_wave(0.011)
        assert sched.straggler_events == 1
    inst = [e for e in teng.tracer.events() if e["name"] == "sched.straggler"]
    assert len(inst) == 1 and inst[0]["args"]["ratio"] == pytest.approx(10.0)
    eng = _engines(tiny_ralm)[0]
    _serve(eng, tiny_ralm["corpus"], n=1, steps=4)
    assert len(eng.scheduler.straggler.durations) == 4


def test_straggler_monitor():
    """``tests/test_fault_tolerance.py::test_straggler_monitor`` on the
    port's monitor, and the same events as the reference's on a noisy
    stream."""
    events = []
    mon = StragglerMonitor(threshold=2.0, on_straggler=events.append)
    for s in range(20):
        mon.record(s, 0.1)
    mon.record(20, 0.5)
    assert len(events) == 1
    assert events[0].step == 20 and events[0].ratio > 2.0
    mon.record(21, 0.11)
    assert len(events) == 1
    rng = np.random.default_rng(1)
    stream = rng.lognormal(mean=-3.0, sigma=0.5, size=300)
    ours, ref = StragglerMonitor(), JaxMonitor()
    for i, d in enumerate(stream):
        a, b = ours.record(i, float(d)), ref.record(i, float(d))
        assert (a is None) == (b is None)
    assert [(e.step, e.ratio) for e in ours.events] == \
        [(e.step, e.ratio) for e in ref.events]
    assert ours.events


def test_fault_metrics_families(tiny_ralm):
    from repro.obs import MetricsRegistry as JaxRegistry
    from repro.obs import bind_engine_metrics as jax_bind
    corpus = tiny_ralm["corpus"]
    teng, jeng = _engines(tiny_ralm, failover=NO_COMEBACK,
                          plan=crash_plan(replica=1))
    _serve(teng, corpus, n=1, steps=4)
    _serve(jeng, corpus, n=1, steps=4)
    teng.scheduler._record_wave(0.01)
    reg = MetricsRegistry()
    bind_engine_metrics(reg, teng)
    text = reg.render()
    assert 'ralm_retrieval_fault_total{kind="crash"}' in text
    assert 'ralm_retrieval_fault_total{kind="partial_flush"}' in text
    assert 'ralm_retrieval_fault_replicas{state="ejected"}' in text
    assert "ralm_retrieval_fault_dispatch_seconds" in text
    assert "ralm_wave_straggler_total" in text
    jreg = JaxRegistry()
    jax_bind(jreg, jeng)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert snap["ralm_retrieval_fault_total"] == \
        jsnap["ralm_retrieval_fault_total"]
    assert snap["ralm_retrieval_fault_replicas"] == \
        jsnap["ralm_retrieval_fault_replicas"]
    assert set(snap) == set(jsnap) - {"ralm_kernel_fallbacks_total"}


def test_engine_config_arms_fault_tolerance(tiny_ralm, tmp_path):
    t = tiny_ralm
    path = str(tmp_path / "plan.json")
    crash_plan(replica=1).save(path)
    econfig = EngineConfig(model=t["tcfg"],
                           rag=RagConfig(**dataclasses.asdict(t["rag"])),
                           async_retrieval=True, shard_replicas=2,
                           retrieval_deadline_s=0.05, hedge_quantile=0.9,
                           chaos_plan=path, trace=True,
                           trace_path=str(tmp_path / "t.json"))
    eng = RalmEngine.from_config(econfig, t["tparams"], t["tds"],
                                 t["tds"].search_config(nprobe=4, k=8),
                                 device="cpu")
    svc = eng.retriever.service
    assert svc.replicas is not None and svc.replicas.cfg.replicas == 2
    assert svc.replicas.cfg.dispatch_deadline_s == 0.05
    assert svc.replicas.cfg.hedge_quantile == 0.9
    assert svc.chaos is not None and svc.chaos.plan.faults[0].kind == "crash"
    assert svc.tracer is eng.tracer and eng.tracer.enabled
    _serve(eng, t["corpus"], n=1, steps=3)
    assert svc.stats.ft_crashes >= 1
    assert eng.write_trace() == str(tmp_path / "t.json")
    with open(tmp_path / "t.json") as fh:
        assert validate_chrome_trace(json.load(fh)) == []


def test_engine_config_ft_requires_async_retrieval(tiny_ralm):
    t = tiny_ralm
    econfig = EngineConfig(model=t["tcfg"],
                           rag=RagConfig(**dataclasses.asdict(t["rag"])),
                           async_retrieval=False, shard_replicas=2)
    with pytest.warns(RuntimeWarning, match="async_retrieval"):
        eng = RalmEngine.from_config(econfig, t["tparams"], t["tds"],
                                     t["tds"].search_config(nprobe=4, k=8),
                                     device="cpu")
    assert not hasattr(eng.retriever, "search_async")   # synchronous
    assert eng.retriever.service.replicas is None


def test_tracer_spans_through_real_waves(tiny_ralm, tmp_path):
    """A traced run under a crash plan records the wave phases, the
    retrieval stages, the failover instants and the KV pool's slot
    lifecycle, nested as the reference nests them; the export validates;
    the same run untraced records nothing and gives the same tokens."""
    corpus = tiny_ralm["corpus"]
    plan = crash_plan(shard=0, replica=0)
    teng, _ = _engines(tiny_ralm, failover=NO_COMEBACK, plan=plan)
    tr = Tracer()
    teng.set_tracer(tr)
    out = _serve(teng, corpus, n=2, steps=5)
    quiet, _ = _engines(tiny_ralm, failover=NO_COMEBACK, plan=plan)
    qout = _serve(quiet, corpus, n=2, steps=5)
    _assert_same(out, qout)
    assert quiet.tracer.events() == []
    doc = tr.export()
    assert validate_chrome_trace(doc) == []
    names = {}
    for e in doc["traceEvents"]:
        names[e["name"]] = names.get(e["name"], 0) + 1
    for n in ("sched.step", "wave.decode", "wave.search", "wave.finish",
              "sched.admit", "queue.wait", "retrieval.queue_wait",
              "retrieval.scan", "retrieval.merge", "kvpool.alloc",
              "kvpool.release", "retrieval.eject"):
        assert names.get(n, 0) >= 1, n
    st = teng.retriever.service.stats
    assert names["retrieval.scan"] == st.num_batches
    assert names["sched.step"] == 5 and names["kvpool.alloc"] == 2
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M"}
    by = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert tracks[by["wave.decode"]["tid"]] == "wave"
    assert tracks[by["retrieval.scan"]["tid"]] == "retrieval"
    path = teng.write_trace(str(tmp_path / "trace.json"))
    with open(path) as fh:
        assert len(json.load(fh)["traceEvents"]) == len(doc["traceEvents"])


def test_spec_metrics_families(tiny_ralm):
    """``tests/test_speculation.py::test_spec_metrics_families`` on the
    port: the ralm_spec_* families after a speculating run, with the
    JAX engine's values."""
    from repro.obs import MetricsRegistry as JaxRegistry
    from repro.obs import bind_engine_metrics as jax_bind
    teng, jeng = _engines(tiny_ralm, spec_k=1)
    _serve(teng, tiny_ralm["corpus"], n=2, steps=6)
    _serve(jeng, tiny_ralm["corpus"], n=2, steps=6)
    reg, jreg = MetricsRegistry(), JaxRegistry()
    bind_engine_metrics(reg, teng)
    jax_bind(jreg, jeng)
    text = reg.render()
    assert "ralm_spec_issued_total" in text
    assert 'ralm_spec_verified_total{outcome="accepted"}' in text
    assert 'ralm_spec_verified_total{outcome="rollback"}' in text
    assert "ralm_spec_landed_total" in text
    assert "ralm_spec_acceptance_rate" in text
    assert 'ralm_retrieval_cache_total{result="stale"}' in text
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    for fam in ("ralm_spec_issued_total", "ralm_spec_verified_total",
                "ralm_spec_discarded_total", "ralm_spec_replayed_steps_total",
                "ralm_spec_acceptance_rate", "ralm_retrieval_queries_total",
                "ralm_retrieval_batches_total", "ralm_kv_allocs_total"):
        assert snap[fam] == jsnap[fam], fam
