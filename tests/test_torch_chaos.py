"""The port's fault-tolerant retrieval dispatch against the reference,
replayed from ``tests/test_chaos.py`` (unit and service level).

Control plane: the replica health walk, ``pick``'s routing and probe
cadence, the hedge delay and ``FaultSpec`` validation run the same
event sequences on both packages' ``ReplicaGroup``s; ``ChaosInjector``
outcomes are equal over a grid of (flush, shard, replica, attempt), and
a plan saved by one package loads in the other.

Service level: the ``tiny_ralm`` datastore (two shards, so two fault
domains) is built by the reference and converted leaf for leaf. Each
case runs the port's service and the JAX service under the same
``FaultPlan`` and the same queries: retrieval ids must be exact,
distances within 1e-5 relative, ``partial`` / ``live_fraction`` and
the ``ft_*`` counters equal. The cases: inert without faults, failover
at full quality, a hang hedged until ejection, a shard down giving the
exact prefix over the survivor (fused and staged), total loss then
recovery (the loss flush runs no scan), ``allow_partial=False`` raising
without wedging, the degraded-partial rung shedding the tail, partial
results kept out of the cache, a late success counted as a timeout, the
merge fanout reaching the hierarchical merge, and the deadline flush.
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
from repro.retrieval import ChaosInjector as JaxInjector
from repro.retrieval import FailoverConfig as JaxFailover
from repro.retrieval import FaultPlan as JaxPlan
from repro.retrieval import FaultSpec as JaxSpec
from repro.retrieval import ReplicaGroup as JaxGroup
from repro.retrieval import RetrievalService as JaxService
from repro.retrieval import ScanHang as JaxScanHang
from repro.retrieval import ServiceConfig as JaxServiceConfig
from repro.retrieval import merge as jmerge
from repro.serve import DatastoreBuilder as JaxBuilder
from repro_torch import convert
from repro_torch.retrieval import (ChaosInjector, FailoverConfig, FaultPlan,
                                   FaultSpec, ReplicaGroup, RetrievalService,
                                   ScanHang, ServiceConfig, crash_plan)
from repro_torch.retrieval import merge as tmerge
from repro_torch.retrieval.replica import (EJECTED, HEALTHY, PROBATION,
                                           SUSPECT)

FT_COUNTERS = ("ft_timeouts", "ft_hedges", "ft_retries", "ft_crashes",
               "ft_ejections", "ft_recoveries", "ft_partial_flushes",
               "ft_partial_rows")

#: failover for failover tests: the long probation keeps a faulted
#: replica benched, so the surviving one serves deterministically
NO_COMEBACK = dict(replicas=2, probation_s=999.0)
#: fast healing: an ejected replica is probe-eligible at once
HEALING = dict(replicas=2, probation_s=0.0, probation_successes=1,
               probe_every=2)


@pytest.fixture(scope="module")
def tiny_ralm():
    """The reference's chaos fixture: a reduced Dec-S LM over the
    deterministic-bigram corpus and a 2-shard datastore, converted."""
    cfg = dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    corpus = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        corpus.append((3 * corpus[-1] + 1) % 64)
    corpus = np.stack(corpus, axis=1).astype(np.int32)
    ds = JaxBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512,
                    num_shards=2).from_corpus(params, cfg, corpus)
    tds = convert.datastore(
        dataclasses.asdict(ds.index_cfg), np.array(ds.params.coarse_centroids),
        np.array(ds.params.codebooks),
        [(np.array(s.codes), np.array(s.ids), np.array(s.list_len))
         for s in ds.shards],
        payload_tokens=np.array(ds.payload_tokens),
        num_vectors=ds.num_vectors)
    assert tds.num_shards == 2
    return dict(ds=ds, tds=tds)


def _queries(t, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, t["ds"].index_cfg.dim)).astype(np.float32)


def _jax_plan(plan):
    return JaxPlan.from_json(plan.to_json())


class Pair:
    """The port's service and the JAX service, built from one set of
    knobs and one plan, searched with the same queries and checked
    against each other after every search."""

    def __init__(self, t, failover=None, plan=None, fused=True, shards=None,
                 **cfg_kw):
        ds, tds = t["ds"], t["tds"]
        idx = range(2) if shards is None else shards
        self.port = RetrievalService.local(
            tds.params, [tds.shards[i] for i in idx],
            tds.search_config(nprobe=4, k=8, fused=fused),
            ServiceConfig(measure=False, failover=None if failover is None
                          else FailoverConfig(**failover), **cfg_kw))
        self.jax = JaxService.local(
            ds.params, [ds.shards[i] for i in idx],
            ds.search_config(nprobe=4, k=8, backend="ref", fused=fused),
            JaxServiceConfig(measure=False, failover=None if failover is None
                             else JaxFailover(**failover), **cfg_kw))
        if plan is not None:
            self.port.install_chaos(plan)
            self.jax.install_chaos(_jax_plan(plan))

    def search(self, q):
        h = self.port.submit(torch.from_numpy(q))
        self.port.flush()
        d, i = h.result()
        jh = self.jax.submit(jnp.asarray(q))
        self.jax.flush()
        jd, ji = jh.result()
        d, i = d.numpy(), i.numpy()
        assert d.dtype == np.float32 and i.dtype == np.int32
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5)
        assert (h.partial, h.live_fraction) == (jh.partial,
                                                jh.live_fraction)
        self.check_counters()
        return d, i, h

    def check_counters(self):
        st, jst = self.port.stats, self.jax.stats
        assert {k: getattr(st, k) for k in FT_COUNTERS} == \
            {k: getattr(jst, k) for k in FT_COUNTERS}
        assert st.num_batches == jst.num_batches
        if self.port.replicas is not None:
            assert self.port.replicas.state_counts() == \
                self.jax.replicas.state_counts()

    @property
    def stats(self):
        return self.port.stats


# ---------------------------------------------------------------------------
# replica health state machine (fake clock, no service)
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _walk(group_cls, failover_cls):
    clk = _Clock()
    trans = []
    g = group_cls(1, failover_cls(
        replicas=2, suspect_after=1, eject_after=3, probation_s=1.0,
        probation_successes=2), clock=clk,
        on_transition=lambda s, r, old, new: trans.append((old, new)))
    h = g.health[(0, 0)]
    seen = []
    g.report(0, 0, "timeout")
    seen.append(h.state)
    g.report(0, 0, "timeout")
    g.report(0, 0, "timeout")
    seen += [h.state, g.ejections, g.pick(0, exclude={1})]
    clk.t = 1.5
    seen += [g.pick(0, exclude={1}), h.state]
    g.report(0, 0, "ok")
    seen.append(h.state)
    g.report(0, 0, "ok")
    seen += [h.state, g.recoveries]
    for _ in range(3):
        g.report(0, 0, "error")
    clk.t = 3.0
    g.pick(0, exclude={1})
    g.report(0, 0, "error")
    seen.append(h.state)
    g.report(0, 1, "crash")
    seen.append(g.health[(0, 1)].state)
    return seen, trans, g.snapshot()


def test_health_state_machine_walk():
    """healthy -> suspect -> ejected -> (cool-off) probation ->
    recovered; a probation failure re-ejects; a crash ejects at once —
    with the reference's transitions and snapshot."""
    seen, trans, snap = _walk(ReplicaGroup, FailoverConfig)
    assert seen == [SUSPECT, EJECTED, 1, None, 0, PROBATION, PROBATION,
                    HEALTHY, 1, EJECTED, EJECTED]
    assert (HEALTHY, SUSPECT) in trans and (SUSPECT, EJECTED) in trans
    assert (PROBATION, HEALTHY) in trans
    assert (seen, trans, snap) == _walk(JaxGroup, JaxFailover)


def _picks(group_cls, failover_cls):
    clk = _Clock()
    g = group_cls(1, failover_cls(replicas=2, probation_s=1.0,
                                  probe_every=4), clock=clk)
    out = [g.pick(0) for _ in range(4)]
    g.report(0, 0, "crash")
    out += [g.pick(0) for _ in range(6)]
    clk.t = 2.0
    out += [g.pick(0) for _ in range(8)]
    out.append(g.health[(0, 0)].state)
    g2 = group_cls(1, failover_cls(replicas=2, probe_every=2), clock=clk)
    g2.report(0, 0, "timeout")
    out += [g2.health[(0, 0)].state] + [g2.pick(0) for _ in range(4)]
    return out


def test_pick_routes_and_probes():
    """Healthy round-robin (the first pick is replica 1), an ejected
    replica benched until its cool-off, then probed on the cadence; a
    suspect revisited — the reference's pick sequence."""
    out = _picks(ReplicaGroup, FailoverConfig)
    assert out[:4] == [1, 0, 1, 0] and out[4:10] == [1] * 6
    assert 0 in out[10:18] and out[18] == PROBATION
    assert out[19] == SUSPECT and 0 in out[20:]
    assert out == _picks(JaxGroup, JaxFailover)


def test_hedge_delay_and_validation():
    g = ReplicaGroup(2, FailoverConfig(replicas=2, hedge_floor_s=0.005,
                                       hedge_quantile=0.5))
    jg = JaxGroup(2, JaxFailover(replicas=2, hedge_floor_s=0.005,
                                 hedge_quantile=0.5))
    assert g.hedge_delay_s() == 0.005
    rng = np.random.default_rng(4)
    for v in rng.exponential(0.02, size=700):
        g.report(0, 1, "ok", latency_s=float(v))
        jg.report(0, 1, "ok", latency_s=float(v))
    assert g.hedge_delay_s() == jg.hedge_delay_s()
    assert g.hedge_delay_s() == pytest.approx(0.02 * np.log(2), rel=0.2)
    with pytest.raises(ValueError, match="replica"):
        ReplicaGroup(0, FailoverConfig())
    with pytest.raises(ValueError, match="unknown outcome"):
        g.report(0, 0, "meh")


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultSpec(kind="meteor")
    with pytest.raises(ValueError, match="p must"):
        FaultSpec(kind="hang", p=1.5)


# ---------------------------------------------------------------------------
# chaos plans: determinism across packages, JSON in both directions
# ---------------------------------------------------------------------------

_RULES = [dict(kind="crash", shard=0, start_flush=2, stop_flush=4),
          dict(kind="hang", replica=1, p=0.3, start_flush=5),
          dict(kind="slow", p=0.5, slow_s=0.01),
          dict(kind="error", shard=1, p=0.7)]


def test_chaos_outcomes_equal_reference():
    """``ChaosInjector.outcome`` is numpy's seeded draw over (seed, rule,
    flush, shard, replica, attempt): the port's outcome equals the
    reference's at every grid point, and the injected counts agree."""
    plan = FaultPlan.make([FaultSpec(**r) for r in _RULES], seed=11)
    a, b = ChaosInjector(plan), JaxInjector(_jax_plan(plan))
    grid = [(f, s, r, t) for f in range(24) for s in range(2)
            for r in range(2) for t in range(3)]
    kinds = [(o.kind if o else None) for o in (a.outcome(*g) for g in grid)]
    jkinds = [(o.kind if o else None) for o in (b.outcome(*g) for g in grid)]
    assert kinds == jkinds
    assert a.counts() == b.counts()
    assert set(kinds) == {None, "crash", "hang", "slow", "error"}
    assert a.outcome(2, 0, 0, 0).kind == "crash"   # the narrow rule wins
    assert any((a.outcome(f, 1, 0, 0) is None) !=
               (a.outcome(f, 1, 0, 1) is None) for f in range(64))


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_fault_plan_json_crosses_packages(tmp_path, direction):
    path = str(tmp_path / "plan.json")
    specs = [dict(kind="hang", shard=1, replica=0, start_flush=3),
             dict(kind="error", p=0.25), dict(kind="slow", slow_s=0.5)]
    ours = FaultPlan.make([FaultSpec(**f) for f in specs], seed=42,
                          realtime=True)
    ref = JaxPlan.make([JaxSpec(**f) for f in specs], seed=42, realtime=True)
    if direction == "torch_to_jax":
        ours.save(path)
        loaded, want = JaxPlan.load(path), ref
    else:
        ref.save(path)
        loaded, want = FaultPlan.load(path), ours
    assert loaded == want
    assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    assert FaultPlan.load(path).to_json() == JaxPlan.load(path).to_json()


# ---------------------------------------------------------------------------
# service-level dispatch, against the JAX service under the same plan
# ---------------------------------------------------------------------------

def test_ft_layer_inert_without_faults(tiny_ralm):
    """FT armed but fault-free == the direct dispatch, bit for bit, with
    every fault counter zero."""
    q = _queries(tiny_ralm)
    d0, i0, _ = Pair(tiny_ralm).search(q)
    pair = Pair(tiny_ralm, failover=dict(replicas=2))
    d1, i1, h = pair.search(q)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    assert not h.partial and h.live_fraction == 1.0
    assert all(getattr(pair.stats, k) == 0 for k in FT_COUNTERS)
    assert pair.stats.scan_dispatches == 1


@pytest.mark.parametrize("kind,counter", [
    ("crash", "ft_crashes"), ("hang", "ft_hedges"), ("error", "ft_retries")])
def test_replica_fault_fails_over_full_quality(tiny_ralm, kind, counter):
    """Replica 1 of every domain faults (the first pick): the dispatch
    fails over / hedges / retries to the sibling and serves bit-identical
    full-quality results; the scan still runs once."""
    q = _queries(tiny_ralm)
    d0, i0, _ = Pair(tiny_ralm).search(q)
    pair = Pair(tiny_ralm, failover=NO_COMEBACK,
                plan=FaultPlan.make([FaultSpec(kind=kind, replica=1)]))
    d1, i1, h = pair.search(q)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    assert not h.partial and getattr(pair.stats, counter) >= 1
    assert pair.stats.ft_partial_flushes == 0
    assert pair.stats.scan_dispatches == 1


def test_hang_keeps_hedging_until_ejection(tiny_ralm):
    """A persistently hanging replica is revisited on the probe cadence,
    each visit hedges, and the failure streak reaches ejection."""
    pair = Pair(tiny_ralm, failover=dict(replicas=2, probation_s=999.0,
                                         probe_every=2),
                plan=FaultPlan.make([FaultSpec(kind="hang", replica=0)]))
    q = _queries(tiny_ralm, n=2)
    for _ in range(16):
        pair.search(q)
    st = pair.stats
    assert st.ft_hedges >= 4 and st.ft_timeouts >= 4
    assert st.ft_ejections == 2
    assert pair.port.replicas.state_counts()[EJECTED] == 2
    assert st.ft_partial_flushes == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_shard_down_serves_exact_prefix_over_survivors(tiny_ralm, fused):
    """Both replicas of domain 0 crash: the flush serves the truncated
    top-k' of the surviving shard — its first k' columns equal the
    exact single-shard search, the tail is (+inf, -1) — in the fused and
    the staged deployment alike."""
    q = _queries(tiny_ralm)
    pair = Pair(tiny_ralm, failover=NO_COMEBACK, fused=fused,
                plan=crash_plan(shard=0, replica=-1))
    d1, i1, h = pair.search(q)
    assert h.partial and h.live_fraction == 0.5
    dr, ir, _ = Pair(tiny_ralm, fused=fused, shards=[1]).search(q)
    kk = pair.port.pipeline.kk
    np.testing.assert_array_equal(i1[:, :kk], ir[:, :kk])
    np.testing.assert_array_equal(d1[:, :kk], dr[:, :kk])
    assert (i1[:, kk:] == -1).all() and np.isinf(d1[:, kk:]).all()
    st = pair.stats
    assert st.ft_crashes == 2 and st.ft_ejections == 2
    assert st.ft_partial_flushes == 1 and st.ft_partial_rows == q.shape[0]


def test_total_loss_sentinel_then_recovery(tiny_ralm):
    """Every replica of every domain crashes for two flushes: the first
    launches its scan once (then every replica crashes), the second has
    no target and runs no scan at all; both serve the all-sentinel
    result; after the window the probation machine restores full
    quality."""
    q = _queries(tiny_ralm, n=2)
    d0, i0, _ = Pair(tiny_ralm).search(q)
    pair = Pair(tiny_ralm, failover=dict(HEALING, probation_s=999.0),
                plan=crash_plan(shard=-1, replica=-1, start=0, stop=2))
    scans = []
    scan = pair.port.pipeline.scan
    pair.port.pipeline.scan = lambda b: scans.append(1) or scan(b)
    d1, i1, h = pair.search(q)
    assert h.partial and h.live_fraction == 0.0
    assert (i1 == -1).all() and np.isinf(d1).all()
    assert len(scans) == 1 and pair.stats.scan_dispatches == 1
    d2, i2, h2 = pair.search(q)                # every replica ejected
    assert h2.partial and (i2 == -1).all() and np.isinf(d2).all()
    assert len(scans) == 1 and pair.stats.scan_dispatches == 1
    assert pair.stats.num_batches == 2
    assert h2._entry.result_d.device.type == "cpu"

    heal = Pair(tiny_ralm, failover=HEALING,
                plan=crash_plan(shard=-1, replica=-1, start=0, stop=2))
    heal.search(q)
    for _ in range(4):
        d3, i3, h3 = heal.search(q)
    np.testing.assert_array_equal(d3, d0)
    np.testing.assert_array_equal(i3, i0)
    assert not h3.partial and heal.stats.ft_recoveries >= 2
    assert heal.port.replicas.state_counts()[EJECTED] == 0


def test_allow_partial_false_raises_but_never_wedges(tiny_ralm):
    """allow_partial=False surfaces total loss as ScanHang, and the
    failed entries still resolve to the sentinel, as in the reference."""
    ds, tds = tiny_ralm["ds"], tiny_ralm["tds"]
    q = _queries(tiny_ralm, n=2)
    svc = RetrievalService.local(
        tds.params, tds.shards, tds.search_config(nprobe=4, k=8),
        ServiceConfig(measure=False, failover=FailoverConfig(
            replicas=1, allow_partial=False)))
    svc.install_chaos(crash_plan(replica=-1))
    jsvc = JaxService.local(
        ds.params, ds.shards, ds.search_config(nprobe=4, k=8, backend="ref"),
        JaxServiceConfig(measure=False, failover=JaxFailover(
            replicas=1, allow_partial=False)))
    jsvc.install_chaos(_jax_plan(crash_plan(replica=-1)))
    h, jh = svc.submit(torch.from_numpy(q)), jsvc.submit(jnp.asarray(q))
    with pytest.raises(ScanHang):
        svc.flush()
    with pytest.raises(JaxScanHang):
        jsvc.flush()
    assert h.done() and h.partial and jh.partial
    d, i = h.result()
    assert (i == -1).all() and torch.isinf(d).all()
    np.testing.assert_array_equal(i.numpy(), np.asarray(jh.result()[1]))
    assert svc.num_inflight == 0 and svc.stats.ft_crashes == \
        jsvc.stats.ft_crashes == 2


def test_degraded_partial_sheds_the_tail(tiny_ralm):
    """The partial-retrieval rung: one attempt per domain, so a hanging
    first pick becomes an immediate partial; clearing the rung restores
    failover."""
    pair = Pair(tiny_ralm, failover=NO_COMEBACK,
                plan=FaultPlan.make([FaultSpec(kind="hang", replica=1)]))
    for svc in (pair.port, pair.jax):
        svc.set_degraded_partial(True)
    q = _queries(tiny_ralm, n=2)
    d, i, h = pair.search(q)
    assert h.partial and h.live_fraction == 0.0
    assert pair.stats.ft_hedges == 2
    for svc in (pair.port, pair.jax):
        svc.set_degraded_partial(False)
    _, _, h2 = pair.search(q)
    assert not h2.partial


def test_partial_results_never_enter_the_cache(tiny_ralm):
    """A partial flush serves the survivors but caches nothing: the same
    queries after the outage miss the cache and get full quality."""
    q = _queries(tiny_ralm, n=3)
    d0, i0, _ = Pair(tiny_ralm).search(q)
    pair = Pair(tiny_ralm, failover=HEALING, cache_entries=32,
                plan=crash_plan(shard=1, replica=-1, start=0, stop=1))
    _, _, h = pair.search(q)
    assert h.partial and len(pair.port.cache) == 0
    d1, i1, h1 = pair.search(q)
    assert not h1.partial and pair.stats.cache_hits == 0
    assert pair.stats.cache_misses == 6
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(i1, i0)
    _, _, h2 = pair.search(q)                  # now cached
    assert h2.done() and pair.stats.cache_hits == 3
    assert pair.jax.stats.cache_hits == 3


def test_slow_past_deadline_is_a_late_success(tiny_ralm):
    """A dispatch slower than the deadline still serves its result, and
    counts as a timeout that charges the replica."""
    q = _queries(tiny_ralm, n=2)
    d0, i0, _ = Pair(tiny_ralm).search(q)
    pair = Pair(tiny_ralm, failover=dict(NO_COMEBACK,
                                         dispatch_deadline_s=0.5),
                plan=FaultPlan.make([FaultSpec(kind="slow", shard=0,
                                               slow_s=5.0)]))
    d1, i1, h = pair.search(q)
    np.testing.assert_array_equal(i1, i0)
    assert not h.partial and pair.stats.ft_timeouts == 1
    assert pair.port.replicas.state_counts()[SUSPECT] == 1


@pytest.mark.parametrize("fanout", [None, 2, 3])
def test_merge_topk_and_mask_producers_equal_reference(fanout):
    rng = np.random.default_rng(5)
    S, nq, c, k = 5, 6, 7, 12
    d = np.sort(rng.normal(size=(S, nq, c)).astype(np.float32), axis=-1)
    d[1, :, 3:] = np.inf
    ids = rng.permutation(S * nq * c).reshape(S, nq, c).astype(np.int32)
    live = np.array([True, False, True, True, False])
    td, ti = tmerge.mask_producers(torch.from_numpy(d),
                                   torch.from_numpy(ids), live)
    jd, ji = jmerge.mask_producers(jnp.asarray(d), jnp.asarray(ids),
                                   jnp.asarray(live))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    od, oi = tmerge.merge_topk(td, ti, k, fanout=fanout)
    rd, ri = jmerge.merge_topk(jd, ji, k, fanout=fanout)
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(od.numpy(), np.asarray(rd))


def test_merge_fanout_reaches_hierarchical(tiny_ralm, monkeypatch):
    """``ServiceConfig.merge_fanout >= 2`` routes the service's merge
    through the hierarchical merge, with the flat merge's results."""
    calls = []
    hier = tmerge.hierarchical_merge
    monkeypatch.setattr(tmerge, "hierarchical_merge",
                        lambda *a, **k: calls.append(1) or hier(*a, **k))
    q = _queries(tiny_ralm)
    d0, i0, _ = Pair(tiny_ralm).search(q)
    assert not calls
    d1, i1, _ = Pair(tiny_ralm, merge_fanout=2).search(q)
    assert len(calls) == 1
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)


def test_deadline_poll_flushes(tiny_ralm):
    """``deadline_s``: a pending row older than the deadline is flushed
    by ``poll`` (and not before), as in the reference."""
    q = _queries(tiny_ralm, n=2)
    pair = Pair(tiny_ralm, deadline_s=10.0, max_batch=64)
    h = pair.port.submit(torch.from_numpy(q))
    jh = pair.jax.submit(jnp.asarray(q))
    t_sub = h._entry.submit_t
    pair.port.poll(t_sub + 5.0)
    pair.jax.poll(jh._entry.submit_t + 5.0)
    assert not h.done() and not jh.done()
    pair.port.poll(t_sub + 10.0)
    pair.jax.poll(jh._entry.submit_t + 10.0)
    assert h.done() and jh.done()
    np.testing.assert_array_equal(h.result()[1].numpy(),
                                  np.asarray(jh.result()[1]))
    assert pair.stats.num_batches == pair.jax.stats.num_batches == 1
