"""The serving surface's observability and quality knobs in the port,
replayed from ``tests/test_obs.py`` (trace ids, the gateway endpoints),
``tests/test_chaos.py`` (cancel, the partial-retrieval rung) and
``tests/test_speculation.py`` (the ladder flushes speculation).

  * a request's trace id is defaulted at submit and rides its spans
    through a real wave; the flow arrow opened at admission closes at
    the first token, paired on the request id. The reference's list of
    spans includes ``jit.decode_compile``; the port compiles nothing per
    wave shape, so that span is left out here;
  * ``/metricsz``, ``/tracez`` and ``/statsz`` of a live gateway;
    ``bind_gateway_metrics`` registers the reference's families, each
    with the reference's type. ``/statsz``'s ``kernels`` block reports
    launch counts where the reference reports Pallas fallbacks;
  * a cancel mid-wave with speculation in flight retires every search
    and frees every slot;
  * the degrade ladder's partial rung exists only with replicas, and a
    walk sets and clears the service's partial mode; an nprobe rung
    force-verifies speculation and marks the result cache stale.
"""
import dataclasses
import json
import re
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import transformer as jtf
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import Tracer as JaxTracer
from repro.obs.adapters import bind_gateway_metrics as jax_bind_gateway
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro.serve.gateway import Gateway as JaxGateway
from repro_torch import convert
from repro_torch.obs import (MetricsRegistry, Tracer, bind_gateway_metrics,
                             validate_chrome_trace)
from repro_torch.retrieval import (FailoverConfig, RetrievalService,
                                   ServiceConfig)
from repro_torch.serve import RagConfig, RalmEngine, RalmRequest
from repro_torch.serve.gateway import (DegradeConfig, DegradePolicy, Gateway,
                                       GatewayConfig)

SOCKET_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def tiny_ralm():
    cfg = dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    corpus = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        corpus.append((3 * corpus[-1] + 1) % 64)
    corpus = np.stack(corpus, axis=1).astype(np.int32)
    ds = JaxBuilder(dim=cfg.d_model, nlist=8, m=8,
                    list_cap=512).from_corpus(params, cfg, corpus)
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
                jccfg=ds.search_config(nprobe=4, k=8, backend="ref"),
                tcfg=tcfg, tparams=tparams, tds=tds,
                tccfg=tds.search_config(nprobe=4, k=8),
                trag=RagConfig(**dataclasses.asdict(rag)))


def _traced_engine(t, enabled=True, **kw):
    kw.setdefault("max_seq", 64)
    kw.setdefault("kv_slots", 8)
    kw.setdefault("attn_seq_block", 64)
    eng = RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"],
                                t["tds"].async_retriever(t["tccfg"]), **kw)
    eng.set_tracer(Tracer(enabled=enabled))
    return eng


# ---------------------------------------------------------------------------
# trace-id propagation through a real scheduler wave
# ---------------------------------------------------------------------------

SPANS = ("queue.wait", "sched.admit", "sched.step", "wave.decode",
         "wave.search", "wave.finish", "retrieval.queue_wait",
         "retrieval.scan", "retrieval.merge", "retrieval.gather",
         "kvpool.alloc", "kvpool.release")


def test_trace_id_propagates_through_wave(tiny_ralm):
    """One request end to end: every span of the reference's list (but
    ``jit.decode_compile``: nothing compiles here) on the right track,
    and the flow arrow from admission to the first-token wave paired on
    the request id, as in the JAX engine's trace of the same run."""
    corpus = tiny_ralm["corpus"]
    eng = _traced_engine(tiny_ralm)
    req = RalmRequest(prompt=torch.from_numpy(corpus[:2, :8]), steps=3,
                      tenant="traced")
    rid = eng.submit(req)
    assert req.trace_id == rid
    eng.run()
    doc = eng.tracer.export()
    assert validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    names = {e["name"] for e in evs}
    for expected in SPANS:
        assert expected in names, f"span {expected!r} missing"
    tracks = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    by_name = {e["name"]: e for e in evs if e["ph"] in ("X", "i")}
    assert tracks[by_name["wave.decode"]["tid"]] == "wave"
    assert tracks[by_name["retrieval.scan"]["tid"]] == "retrieval"
    assert tracks[by_name["kvpool.alloc"]["tid"]] == "kvpool"
    assert by_name["sched.admit"]["args"]["request_id"] == rid
    wait = by_name["queue.wait"]
    assert wait["args"]["trace_id"] == rid
    assert wait["args"]["tenant"] == "traced"
    flows = [e for e in evs if e.get("cat") == "flow"]
    assert sorted(e["ph"] for e in flows) == ["f", "s"]
    assert all(e["id"] == rid for e in flows)
    assert tracks[next(e for e in flows if e["ph"] == "f")["tid"]] == "wave"
    steps = [e for e in evs if e["name"] == "sched.step"]
    assert len(steps) == 3
    assert wait["ts"] + wait["dur"] <= steps[0]["ts"] + steps[0]["dur"] + 1.0

    jeng = JaxEngine.monolithic(
        tiny_ralm["params"], tiny_ralm["cfg"], tiny_ralm["rag"],
        tiny_ralm["ds"].async_retriever(tiny_ralm["jccfg"]), max_seq=64,
        kv_slots=8, attn_seq_block=64)
    jeng.set_tracer(JaxTracer(enabled=True))
    jrid = jeng.submit(JaxRequest(prompt=jnp.asarray(corpus[:2, :8]),
                                  steps=3, tenant="traced"))
    jeng.run()
    jevs = jeng.tracer.export()["traceEvents"]
    jflows = [e for e in jevs if e.get("cat") == "flow"]
    assert sorted(e["ph"] for e in jflows) == ["f", "s"]
    assert all(e["id"] == jrid == rid for e in jflows)
    jnames = {e["name"] for e in jevs} - {"jit.decode_compile"}
    assert jnames <= names, jnames - names


def test_disabled_tracer_records_nothing_on_wave(tiny_ralm):
    """Same workload, tracing off: zero events, and the same tokens as
    the traced engine (observability is read-only)."""
    corpus = tiny_ralm["corpus"]
    on = _traced_engine(tiny_ralm)
    off = _traced_engine(tiny_ralm, enabled=False)
    out_on = on.generate(torch.from_numpy(corpus[:2, :8]), steps=3)
    out_off = off.generate(torch.from_numpy(corpus[:2, :8]), steps=3)
    assert off.tracer.events() == []
    assert len(on.tracer.events()) > 0
    np.testing.assert_array_equal(out_on, out_off)


# ---------------------------------------------------------------------------
# the gateway endpoints: /metricsz, /tracez, /statsz
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def obs_gw(tiny_ralm):
    # the Gateway takes engine.tracer at construction: install it first
    gateway = Gateway(_traced_engine(tiny_ralm), GatewayConfig())
    gateway.start_background()
    try:
        _stream_one(gateway.port, tiny_ralm["corpus"][0, :8].tolist())
        yield gateway
    finally:
        gateway.shutdown()


def _get(port, path):
    s = socket.create_connection(("127.0.0.1", port),
                                 timeout=SOCKET_TIMEOUT_S)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    raw = b""
    while True:
        data = s.recv(65536)
        if not data:
            break
        raw += data
    s.close()
    head, body = raw.split(b"\r\n\r\n", 1)
    status = int(head.split(b"\r\n")[0].split()[1])
    headers = {}
    for ln in head.decode().split("\r\n")[1:]:
        k, v = ln.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    return status, headers, body


def _stream_one(port, prompt, max_tokens=4):
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "stream": True}).encode()
    req = (f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
           f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    s = socket.create_connection(("127.0.0.1", port),
                                 timeout=SOCKET_TIMEOUT_S)
    s.sendall(req)
    buf = b""
    while b"data: [DONE]\n\n" not in buf:
        data = s.recv(4096)
        assert data, "stream closed early"
        buf += data
    s.close()


_LV = r'"(?:[^"\\\n]|\\.)*"'                             # label value
SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'                         # metric name
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*=' + _LV +                # first label
    r'(,[a-zA-Z_][a-zA-Z0-9_]*=' + _LV + r')*\})?'       # more labels
    r' (-?\d+(\.\d+)?([eE][-+]?\d+)?|[+-]Inf|NaN)$')     # value


def _check_exposition(text):
    """Prometheus text-format invariants (``tests/test_obs.py``): every
    sample line parses, one TYPE per family, no duplicate sample names.
    Returns {family: type}."""
    typed, seen = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            assert name not in typed, f"duplicate TYPE for {name}"
            typed[name] = kind
        elif line and not line.startswith("#"):
            assert SAMPLE_RE.match(line), f"bad sample line: {line!r}"
            seen.append(line.rsplit(" ", 1)[0])
    assert len(seen) == len(set(seen)), "duplicate sample names"
    return typed


def test_gateway_metricsz_exposition(obs_gw):
    status, headers, body = _get(obs_gw.port, "/metricsz")
    assert status == 200
    assert headers["content-type"].startswith("text/plain")
    text = body.decode()
    _check_exposition(text)
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, v = line.rpartition(" ")
            samples[name] = float(v)
    assert samples["ralm_ttft_seconds_count"] >= 1
    assert samples["ralm_ttft_seconds_p50"] > 0
    assert samples["ralm_completions_total"] >= 1
    assert samples["ralm_tokens_out_total"] >= 1
    assert samples['ralm_admission_total{outcome="admitted"}'] >= 1
    assert samples['ralm_kv_slots{state="used"}'] == 0   # idle now
    assert "ralm_retrieval_queries_total" in samples
    assert samples['ralm_retrieval_stage_seconds'
                   '{stage="scan",stat="p99"}'] >= 0


def test_gateway_tracez_roundtrip_and_clear(obs_gw):
    status, _, body = _get(obs_gw.port, "/tracez")
    assert status == 200
    doc = json.loads(body)
    assert validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"sched.step", "wave.decode", "retrieval.scan"} <= names
    status, _, body = _get(obs_gw.port, "/tracez?clear=1")
    assert status == 200
    assert validate_chrome_trace(json.loads(body)) == []
    _, _, body = _get(obs_gw.port, "/tracez")
    assert all(e["ph"] == "M" for e in json.loads(body)["traceEvents"])
    _stream_one(obs_gw.port, [1, 2, 3, 4], max_tokens=2)
    _, _, body = _get(obs_gw.port, "/tracez")
    doc = json.loads(body)
    assert validate_chrome_trace(doc) == []
    assert any(e["name"] == "sched.step" for e in doc["traceEvents"])


def test_gateway_statsz_satellite_fields(obs_gw):
    _, _, body = _get(obs_gw.port, "/statsz")
    stats = json.loads(body)
    kv = stats["kv_pool"]
    for key in ("decode_compiles", "skip_fraction", "blocks_total",
                "blocks_skipped"):
        assert key in kv, key
    assert kv["decode_compiles"] >= 1
    kern = stats["kernels"]                    # launches, not fallbacks
    assert isinstance(kern["launches"], dict)
    assert "decode_attn_launch" in kern["launches"]
    assert kern["launch_total"] == sum(kern["launches"].values()) == 0
    ret = stats["retrieval"]
    assert "p50_us" in ret["scan"] and "p99_us" in ret["scan"]
    assert ret["qps"] >= 0
    assert stats["metrics"]["ralm_completions_total"] >= 1
    assert stats["metrics"]["ralm_ttft_seconds"]["count"] >= 1


def test_gateway_metric_families_match_reference(tiny_ralm):
    """``bind_gateway_metrics`` registers the reference's families, each
    of the reference's type (the engine's families included), but the
    reference's ``ralm_kernel_fallbacks_total``: the port never falls
    back."""
    t = tiny_ralm
    jeng = JaxEngine.monolithic(t["params"], t["cfg"], t["rag"],
                                t["ds"].async_retriever(t["jccfg"]))
    reg, jreg = MetricsRegistry(), JaxRegistry()
    bind_gateway_metrics(reg, Gateway(_traced_engine(t)))
    jax_bind_gateway(jreg, JaxGateway(jeng))
    got, want = _check_exposition(reg.render()), \
        _check_exposition(jreg.render())
    want.pop("ralm_kernel_fallbacks_total", None)
    assert got == want
    assert {"ralm_completions_total", "ralm_degrade_level",
            "ralm_admission_total", "ralm_queue_depth"} <= set(got)


# ---------------------------------------------------------------------------
# cancel and the degrade ladder (tests/test_chaos.py, test_speculation.py)
# ---------------------------------------------------------------------------

def _engine(t, failover=None, spec_k=0):
    ret = t["tds"].async_retriever(t["tccfg"], service_cfg=ServiceConfig(
        measure=False, failover=failover))
    return RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"],
                                 retriever=ret, speculate_k=spec_k)


def _run(eng, corpus, steps=8, n=2):
    for i in range(n):
        eng.submit(RalmRequest(
            prompt=torch.from_numpy(corpus[2 * i:2 * i + 2, :4]),
            steps=steps))
    return eng.run()


def test_cancel_mid_wave_releases_everything(tiny_ralm):
    """A cancel mid-decode with speculation in flight retires every
    in-flight search and returns the KV slots; the response is flagged
    and its points are discarded, not verified."""
    corpus = tiny_ralm["corpus"]
    eng = _engine(tiny_ralm, spec_k=1)
    rid = eng.submit(RalmRequest(prompt=torch.from_numpy(corpus[0:2, :4]),
                                 steps=12))
    eng.submit(RalmRequest(prompt=torch.from_numpy(corpus[4:6, :4]),
                           steps=12))
    done = []
    for _ in range(3):
        done += eng.step()
    assert any(seq.spec_points for seq in eng.scheduler.active)
    assert eng.scheduler.cancel(rid)
    done += eng.run()
    by_id = {r.request_id: r for r in done}
    assert by_id[rid].cancelled
    assert eng.retriever.service.num_inflight == 0
    assert eng.pool.num_used == 0
    assert eng.spec_stats.spec_discarded >= 1


def test_spec_finalize_discards_a_cancelled_requests_points(tiny_ralm):
    """``spec_finalize`` on a cancelled request cancels its points'
    searches instead of verifying them; a streaming request never
    speculates (``on_token`` would have seen a retracted token)."""
    corpus = tiny_ralm["corpus"]
    eng = _engine(tiny_ralm, spec_k=2)
    eng.submit(RalmRequest(prompt=torch.from_numpy(corpus[0:2, :4]),
                           steps=12))
    for _ in range(3):
        eng.step()
    (seq,) = eng.scheduler.active
    points = len(seq.spec_points)
    assert points > 0
    verified = eng.spec_stats.spec_verified
    discarded = eng.spec_stats.spec_discarded
    seq.request.cancelled = True
    eng.spec_finalize(seq)
    assert not seq.spec_points
    assert eng.spec_stats.spec_verified == verified
    assert eng.spec_stats.spec_discarded == discarded + points
    eng.run()
    assert eng.retriever.service.num_inflight == 0

    streamed = []
    eng2 = _engine(tiny_ralm, spec_k=2)
    eng2.submit(RalmRequest(
        prompt=torch.from_numpy(corpus[0:2, :4]), steps=6,
        on_token=lambda step, toks: streamed.append((step, toks.tolist()))))
    (resp,) = eng2.run()
    assert eng2.spec_stats.spec_issued == 0
    assert [s for s, _ in streamed] == list(range(6))
    assert [tok for _, tok in streamed] == resp.tokens[:, 4:].T.tolist()
    assert resp.times.ttft_s() > 0 and resp.times.tpot_s(resp.steps) > 0


def test_ladder_includes_partial_rung_only_with_replicas(tiny_ralm):
    eng_ft = _engine(tiny_ralm, failover=FailoverConfig(replicas=2))
    names = [lv.name for lv in DegradePolicy(eng_ft).ladder]
    assert "partial-retrieval" in names
    assert names.index("partial-retrieval") < names.index("knn-off")
    names_plain = [lv.name for lv in DegradePolicy(
        _engine(tiny_ralm)).ladder]
    assert "partial-retrieval" not in names_plain
    names_off = [lv.name for lv in DegradePolicy(
        eng_ft, DegradeConfig(partial_rung=False)).ladder]
    assert "partial-retrieval" not in names_off


def test_ladder_walk_sets_and_clears_partial_mode(tiny_ralm):
    """Sustained pressure walks nprobe -> interval -> partial-retrieval
    (the service enters single-attempt mode); sustained calm walks back
    up and clears it; the recovered level reproduces baseline tokens."""
    corpus = tiny_ralm["corpus"]
    eng = _engine(tiny_ralm, failover=FailoverConfig(replicas=2))
    base = _run(_engine(tiny_ralm), corpus)
    pol = DegradePolicy(eng, DegradeConfig(patience=1, recovery=1,
                                           high_watermark=4,
                                           low_watermark=1))
    svc = eng.retriever.service
    partial_idx = [lv.name for lv in pol.ladder].index("partial-retrieval")
    walked = []
    while pol.level < partial_idx:
        assert pol.observe(queue_depth=100)
        walked.append(pol.ladder[pol.level].name)
    assert svc._degraded_partial
    assert pol.ladder[pol.level].partial
    assert walked[0].startswith("nprobe") and "interval" in walked[-2]
    down = pol.transitions_down
    while pol.level > 0:
        assert pol.observe(queue_depth=0)
    assert not svc._degraded_partial
    assert pol.transitions_down == down and pol.transitions_up == down
    out = _run(eng, corpus)
    for a, b in zip(base, out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_degrade_flushes_speculation_and_keeps_cache(tiny_ralm):
    tds, tccfg = tiny_ralm["tds"], tiny_ralm["tccfg"]
    svc = RetrievalService.local(tds.params, tds.shards, tccfg,
                                 ServiceConfig(cache_entries=32,
                                               measure=False))
    q = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, tds.index_cfg.dim)).astype(np.float32))
    h = svc.submit(q)
    svc.flush()
    h.result()
    eng = types.SimpleNamespace(
        rag=RagConfig(mode="knnlm", interval=1, k=8),
        retriever=types.SimpleNamespace(service=svc), flushed=0)
    eng.flush_speculation = lambda: setattr(eng, "flushed", eng.flushed + 1)
    pol = DegradePolicy(eng)
    cache = svc.cache
    gen0 = cache.generation
    pol.apply(1)                                   # nprobe/2 rung
    assert eng.flushed == 1
    assert svc.pipeline.cfg.nprobe == tccfg.nprobe // 2
    assert svc.pipeline.kk == tccfg.k_prime(len(tds.shards))
    assert svc.cache is cache
    assert cache.generation == gen0 + 1
    assert cache.get_stale(q.numpy()) is not None
    pol.apply(1)                                   # idempotent
    assert eng.flushed == 1
