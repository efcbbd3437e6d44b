"""The port's serving front door, replayed from ``tests/test_gateway.py``.

Every reference test runs here against ``repro_torch.serve.gateway``:
admission bookkeeping on an injected clock, the degrade ladder on stub
engines, and the HTTP gateway over the ``tiny_ralm`` recipe (a reduced
Dec-S LM, vocab 64, over a deterministic-bigram corpus, built by the
reference and converted leaf for leaf). Tokens streamed or returned over
HTTP must equal the JAX engine's greedy tokens, not only the port's.

Cross-package cases drive the same seeded sequence of offers, takes and
cancels through both packages' ``AdmissionController``s, and the same
queue-depth ticks through both ``DegradePolicy``s: verdicts, retry-after
values, levels, ladders and history must be identical.

The HTTP tests share one module-scoped gateway; every socket read has a
timeout and every gateway shuts down in ``finally``, so a hang fails one
test instead of the run.
"""
import dataclasses
import json
import socket
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core.chamvs import ChamVSConfig as JaxChamVSConfig
from repro.core.chamvs import IVFPQConfig as JaxIVFPQConfig
from repro.models import transformer as jtf
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro.serve.gateway import AdmissionController as JaxAdmission
from repro.serve.gateway import DegradeConfig as JaxDegradeConfig
from repro.serve.gateway import DegradePolicy as JaxDegradePolicy
from repro.serve.gateway import TenantQuota as JaxQuota
from repro_torch import convert
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.ivfpq import IVFPQConfig
from repro_torch.serve import RagConfig, RalmEngine, RalmRequest
from repro_torch.serve.gateway import (AdmissionController, DegradeConfig,
                                       DegradePolicy, Gateway, GatewayConfig,
                                       TenantQuota, TokenBucket)

SOCKET_TIMEOUT_S = 120.0

# ---------------------------------------------------------------------------
# admission control (pure host-side units)
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _req(tenant="default", rows=1, rid=None):
    return RalmRequest(prompt=torch.zeros((rows, 4), dtype=torch.int32),
                       steps=1, tenant=tenant, request_id=rid)


def test_token_bucket_rate_and_burst():
    clock = FakeClock()
    b = TokenBucket(TenantQuota(rate=2.0, burst=2.0), clock=clock)
    assert b.try_take() is None and b.try_take() is None  # burst of 2
    wait = b.try_take()                                   # bucket empty
    assert wait == pytest.approx(0.5)                     # 1 token / 2 rps
    clock.t += 0.5
    assert b.try_take() is None                           # refilled
    free = TokenBucket(TenantQuota(), clock=clock)
    assert all(free.try_take() is None for _ in range(100))


def test_admission_quota_429_and_depth_503():
    clock = FakeClock()
    ctl = AdmissionController(
        max_queue_depth=2,
        quotas={"metered": TenantQuota(rate=1.0, burst=1.0)}, clock=clock)
    assert ctl.offer(_req("metered")).admitted
    over = ctl.offer(_req("metered"))              # burst spent
    assert (not over.admitted and over.status == 429
            and over.retry_after_s > 0)
    assert ctl.offer(_req("other")).admitted       # other tenant unaffected
    full = ctl.offer(_req("other"))                # pending == depth bound
    assert not full.admitted and full.status == 503
    ctl2 = AdmissionController(max_queue_depth=2, clock=clock)
    deep = ctl2.offer(_req(), in_system=2)
    assert not deep.admitted and deep.status == 503
    assert ctl.stats()["rejected_quota"] == 1
    assert ctl.stats()["rejected_capacity"] == 1


def test_admission_round_robin_fairness():
    """A burst from one tenant cannot monopolize release order."""
    ctl = AdmissionController(max_queue_depth=100)
    for i in range(4):
        ctl.offer(_req("hog", rid=i))
    ctl.offer(_req("mouse", rid=100))
    order = [ctl.take(lambda r: True).tenant for _ in range(5)]
    assert order.index("mouse") <= 1
    assert ctl.take(lambda r: True) is None


def test_admission_take_respects_fits_and_cancel():
    ctl = AdmissionController(max_queue_depth=10)
    ctl.offer(_req("a", rows=4, rid=1))
    ctl.offer(_req("b", rows=1, rid=2))
    got = ctl.take(lambda r: r.prompt.shape[0] <= 2)
    assert got is not None and got.tenant == "b"
    assert ctl.take(lambda r: r.prompt.shape[0] <= 2) is None
    assert ctl.cancel(1) and not ctl.cancel(1)
    assert ctl.pending == 0


def _admission_script(seed, n=60):
    """A seeded sequence of (op, args): offers from three tenants (one
    metered), takes with a row budget, cancels of earlier ids, and clock
    advances."""
    rng = np.random.default_rng(seed)
    ops = []
    for rid in range(n):
        kind = rng.choice(["offer", "offer", "offer", "take", "cancel",
                           "tick"])
        if kind == "offer":
            ops.append(("offer", rid, str(rng.choice(["a", "b", "metered"])),
                        int(rng.integers(1, 4)), int(rng.integers(0, 4))))
        elif kind == "take":
            ops.append(("take", int(rng.integers(0, 4))))
        elif kind == "cancel":
            ops.append(("cancel", int(rng.integers(0, rid + 1))))
        else:
            ops.append(("tick", float(rng.uniform(0.0, 1.0))))
    return ops


def _run_admission(ctl_cls, quota_cls, make_req, ops):
    clock = FakeClock()
    ctl = ctl_cls(max_queue_depth=6,
                  quotas={"metered": quota_cls(rate=0.3, burst=1.5)},
                  clock=clock)
    out = []
    for op in ops:
        if op[0] == "offer":
            _, rid, tenant, rows, in_system = op
            v = ctl.offer(make_req(tenant, rows, rid), in_system=in_system)
            out.append(("offer", v.admitted, v.status, v.retry_after_s,
                        v.reason))
        elif op[0] == "take":
            got = ctl.take(lambda r, free=op[1]: r.prompt.shape[0] <= free)
            out.append(("take", None if got is None else
                        (got.request_id, got.tenant)))
        elif op[0] == "cancel":
            out.append(("cancel", ctl.cancel(op[1])))
        else:
            clock.t += op[1]
    out.append(("stats", ctl.stats()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_match_reference(seed):
    """Both packages' controllers, one seeded script: identical verdicts
    (status, retry-after, reason), releases, cancels and counters."""
    ops = _admission_script(seed)

    def jreq(tenant, rows, rid):
        # the reference's cancel removes with ``deque.remove``, which
        # compares requests field by field and raises on two jax prompts;
        # the controller reads only ``prompt.shape``, so the reference
        # side gets a shape-only stand-in (the port takes real tensors)
        return JaxRequest(prompt=types.SimpleNamespace(shape=(rows, 4)),
                          steps=1, tenant=tenant, request_id=rid)

    want = _run_admission(JaxAdmission, JaxQuota, jreq, ops)
    got = _run_admission(AdmissionController, TenantQuota,
                         lambda t, r, i: _req(t, r, i), ops)
    assert got == want
    assert any(o[0] == "offer" and o[2] == 429 for o in got)
    assert any(o[0] == "offer" and o[2] == 503 for o in got)


# ---------------------------------------------------------------------------
# degradation policy (stub engines: no device work, real config mutation)
# ---------------------------------------------------------------------------


class _StubRetriever:
    def __init__(self, nprobe, jax_cfg=False):
        if jax_cfg:
            self.cfg = JaxChamVSConfig(JaxIVFPQConfig(dim=32, nlist=8, m=8),
                                       nprobe=nprobe, k=8)
        else:
            self.cfg = ChamVSConfig(IVFPQConfig(dim=32, nlist=8, m=8),
                                    nprobe=nprobe, k=8)


class _StubEngine:
    def __init__(self, nprobe=4, interval=1, jax_cfg=False):
        rag_cls = JaxRagConfig if jax_cfg else RagConfig
        self.rag = rag_cls(mode="knnlm", interval=interval, k=8)
        self.retriever = _StubRetriever(nprobe, jax_cfg)


def test_degrade_ladder_shape():
    pol = DegradePolicy(_StubEngine(nprobe=8))
    names = [lv.name for lv in pol.ladder]
    assert names[0] == "baseline" and names[-1] == "knn-off"
    assert [lv.nprobe for lv in pol.ladder][:4] == [8, 4, 2, 1]
    assert pol.ladder[-2].interval > pol.ladder[0].interval
    bare = _StubEngine()
    bare.rag = RagConfig(mode="none")
    assert len(DegradePolicy(bare).ladder) == 1


def test_degrade_steps_down_and_recovers_with_hysteresis():
    eng = _StubEngine(nprobe=4, interval=1)
    pol = DegradePolicy(eng, DegradeConfig(high_watermark=4,
                                           low_watermark=1, patience=3,
                                           recovery=5))
    assert not pol.observe(10) and not pol.observe(10)
    assert not pol.observe(0) and pol.level == 0
    for _ in range(2):
        pol.observe(10)
    assert pol.observe(10) and pol.level == 1
    assert eng.retriever.cfg.nprobe == 2
    for _ in range(3 * len(pol.ladder)):
        pol.observe(10)
    assert pol.level == len(pol.ladder) - 1
    assert eng.rag.mode == "none"
    pol.observe(3)
    for _ in range(5 * len(pol.ladder)):
        pol.observe(0)
    assert pol.level == 0
    assert eng.rag.mode == "knnlm" and eng.rag.interval == 1
    assert eng.retriever.cfg.nprobe == 4
    st = pol.stats()
    assert st["transitions_down"] == len(pol.ladder) - 1
    assert st["transitions_up"] == len(pol.ladder) - 1
    assert len(pol.history) == st["transitions_down"] + st["transitions_up"]


@pytest.mark.parametrize("seed,nprobe,interval,knobs", [
    (0, 8, 1, dict()),
    (1, 32, 2, dict(high_watermark=4, low_watermark=1, patience=2,
                    recovery=3, min_nprobe=2, interval_factor=3)),
    (2, 4, 1, dict(patience=1, recovery=2, knn_off_rung=False)),
])
def test_degrade_decisions_match_reference(seed, nprobe, interval, knobs):
    """Both packages' policies, the same seeded queue-depth ticks:
    identical ladders, levels after every tick, history (timestamps
    pinned), stats and engine mutations."""
    depths = np.random.default_rng(seed).choice(
        [0, 0, 1, 3, 9, 20], size=300).tolist()
    runs = []
    for jax_side in (True, False):
        eng = _StubEngine(nprobe, interval, jax_cfg=jax_side)
        cfg = (JaxDegradeConfig if jax_side else DegradeConfig)(**knobs)
        pol = (JaxDegradePolicy if jax_side else DegradePolicy)(eng, cfg)
        trail = []
        for t, depth in enumerate(depths):
            changed = pol.observe(depth, now=float(t))
            trail.append((changed, pol.level, eng.rag.mode, eng.rag.interval,
                          eng.retriever.cfg.nprobe))
        runs.append(dict(ladder=[lv.as_dict() for lv in pol.ladder],
                         trail=trail, history=pol.history,
                         stats=pol.stats()))
    assert runs[1] == runs[0]
    assert runs[0]["stats"]["transitions_down"] > 0


# ---------------------------------------------------------------------------
# the HTTP gateway itself
# ---------------------------------------------------------------------------


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
                trag=RagConfig(**dataclasses.asdict(rag)))


def _engine(t, fused=True, **kw):
    kw.setdefault("max_seq", 64)
    kw.setdefault("kv_slots", 8)
    kw.setdefault("attn_seq_block", 64)
    ccfg = t["tds"].search_config(nprobe=4, k=8, fused=fused)
    return RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"],
                                 t["tds"].retriever(ccfg), **kw)


@pytest.fixture(scope="module")
def gw(tiny_ralm):
    gateway = Gateway(_engine(tiny_ralm), GatewayConfig(
        quotas=(("metered", TenantQuota(rate=0.001, burst=1.0)),)))
    gateway.start_background()
    try:
        yield gateway
    finally:
        gateway.shutdown()


def _post(port, payload, tenant=None, timeout=SOCKET_TIMEOUT_S):
    """One POST /v1/completions over a raw socket; returns (socket,
    status, header dict, body bytes read so far)."""
    body = json.dumps(payload).encode()
    tenant_h = f"X-Tenant: {tenant}\r\n" if tenant else ""
    req = (f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n{tenant_h}"
           f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.sendall(req)
    raw = b""
    while b"\r\n\r\n" not in raw:
        data = s.recv(4096)
        assert data, "connection closed before the response head"
        raw += data
    head, rest = raw.split(b"\r\n\r\n", 1)
    lines = head.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        k, v = ln.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    return s, status, headers, rest


def _read_all(s, rest=b""):
    while True:
        data = s.recv(4096)
        if not data:
            break
        rest += data
    s.close()
    return rest


def _drain_sse(s, rest=b""):
    """Read SSE events until [DONE]; returns (token list, final chunk)."""
    buf, toks, final = rest, [], None
    while b"data: [DONE]\n\n" not in buf:
        data = s.recv(4096)
        assert data, "connection closed before [DONE]"
        buf += data
    s.close()
    for event in buf.decode().split("\n\n"):
        if not event.startswith("data: ") or event == "data: [DONE]":
            continue
        obj = json.loads(event[6:])
        choice = obj["choices"][0]
        if choice["finish_reason"] is None:
            toks += [int(t) for t in choice["text"].split()]
        else:
            final = obj
    return toks, final


def _greedy_ref(t, prompt, steps):
    """The JAX engine's greedy continuation of one prompt row."""
    eng = JaxEngine.monolithic(t["params"], t["cfg"], t["rag"],
                               t["ds"].retriever(t["jccfg"]))
    out = eng.generate(jnp.asarray([prompt]), steps=steps)
    return np.asarray(out)[0, len(prompt):].tolist()


def test_http_streaming_greedy_parity(gw, tiny_ralm):
    """Tokens streamed over the wire == the JAX engine's greedy tokens."""
    prompt = tiny_ralm["corpus"][0, :8].tolist()
    s, status, headers, rest = _post(
        gw.port, {"prompt": prompt, "max_tokens": 6, "stream": True})
    assert status == 200
    assert headers["content-type"] == "text/event-stream"
    toks, final = _drain_sse(s, rest)
    assert final["choices"][0]["finish_reason"] == "length"
    assert final["ralm"]["degrade_levels"] == [0]
    assert final["ralm"]["ttft_ms"] > 0
    assert toks == _greedy_ref(tiny_ralm, prompt, 6)


def test_http_blocking_completion_and_usage(gw, tiny_ralm):
    prompt = tiny_ralm["corpus"][1, :8].tolist()
    s, status, _, rest = _post(gw.port, {"prompt": prompt, "max_tokens": 4})
    obj = json.loads(_read_all(s, rest))
    assert status == 200
    assert obj["usage"] == {"prompt_tokens": 8, "completion_tokens": 4,
                            "total_tokens": 12}
    toks = [int(t) for t in obj["choices"][0]["text"].split()]
    assert toks == _greedy_ref(tiny_ralm, prompt, 4)


def test_http_multi_tenant_streams_interleave(gw, tiny_ralm):
    """Two tenants streaming at once: both equal to the JAX engine's
    greedy tokens, and both observed active on the engine together."""
    corpus = tiny_ralm["corpus"]
    pa, pb = corpus[2, :8].tolist(), corpus[3, :8].tolist()
    out = {}

    def client(name, prompt):
        s, status, _, rest = _post(
            gw.port, {"prompt": prompt, "max_tokens": 32, "stream": True},
            tenant=name)
        assert status == 200
        out[name] = _drain_sse(s, rest)

    ta = threading.Thread(target=client, args=("alice", pa))
    ta.start()
    deadline = time.time() + 120
    while gw.scheduler.num_active < 1 and time.time() < deadline:
        time.sleep(0.002)
    assert gw.scheduler.num_active >= 1, "first stream never started"
    tb = threading.Thread(target=client, args=("bob", pb))
    tb.start()
    saw_both = False
    while ta.is_alive() and time.time() < deadline:
        if gw.scheduler.num_active >= 2:
            saw_both = True
            break
        time.sleep(0.002)
    ta.join(timeout=SOCKET_TIMEOUT_S)
    tb.join(timeout=SOCKET_TIMEOUT_S)
    assert not ta.is_alive() and not tb.is_alive()
    assert saw_both, "streams were never active concurrently"
    assert out["alice"][0] == _greedy_ref(tiny_ralm, pa, 32)
    assert out["bob"][0] == _greedy_ref(tiny_ralm, pb, 32)
    assert out["alice"][1]["ralm"]["tenant"] == "alice"
    assert out["bob"][1]["ralm"]["tenant"] == "bob"


def test_http_429_over_quota(gw, tiny_ralm):
    prompt = tiny_ralm["corpus"][4, :8].tolist()
    s, status, _, rest = _post(gw.port, {"prompt": prompt, "max_tokens": 1},
                               tenant="metered")
    _read_all(s, rest)
    assert status == 200
    s, status, headers, _ = _post(gw.port,
                                  {"prompt": prompt, "max_tokens": 1},
                                  tenant="metered")
    s.close()
    assert status == 429
    assert int(headers["retry-after"]) >= 1
    assert gw.admission.rejected_quota >= 1


def test_http_400_bad_requests(gw):
    for payload in ({"prompt": [999], "max_tokens": 1},     # out of vocab
                    {"prompt": [], "max_tokens": 1},        # empty
                    {"prompt": [1, 2], "max_tokens": 0},    # no tokens
                    {"prompt": [1, 2], "max_tokens": 10_000},
                    {"prompt": [1] * 60, "max_tokens": 60}):  # > max_seq
        s, status, _, _ = _post(gw.port, payload)
        s.close()
        assert status == 400, payload


def _get_json(port, path):
    s = socket.create_connection(("127.0.0.1", port),
                                 timeout=SOCKET_TIMEOUT_S)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    raw = _read_all(s)
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


def test_http_statsz_surfaces_queue_observability(gw):
    stats = _get_json(gw.port, "/statsz")
    sched = stats["scheduler"]
    for key in ("queued_requests", "active_requests", "active_rows",
                "queue_age_max_s", "tenant_depth"):
        assert key in sched
    assert stats["admission"]["admitted"] >= 1
    assert stats["degrade"]["level_name"] == "baseline"
    assert stats["kv_pool"]["capacity"] == 8
    assert stats["completions"] >= 1 and stats["tokens_out"] >= 1


def test_disconnect_releases_kv_slot(tiny_ralm):
    """kv_slots=1: a second request can only complete if the first
    client's mid-stream disconnect released its slot."""
    gateway = Gateway(_engine(tiny_ralm, kv_slots=1), GatewayConfig())
    gateway.start_background()
    try:
        prompt = tiny_ralm["corpus"][5, :8].tolist()
        s, status, _, rest = _post(
            gateway.port,
            {"prompt": prompt, "max_tokens": 40, "stream": True})
        assert status == 200
        buf = rest
        while buf.count(b"\n\n") < 2:          # a couple of live tokens
            data = s.recv(4096)
            assert data
            buf += data
        s.close()                              # walk away mid-stream
        s2, status2, _, rest2 = _post(
            gateway.port,
            {"prompt": prompt, "max_tokens": 4, "stream": True})
        assert status2 == 200
        toks, _ = _drain_sse(s2, rest2)
        assert toks == _greedy_ref(tiny_ralm, prompt, 4)
        deadline = time.time() + 30
        while gateway.disconnects < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert gateway.disconnects == 1
        assert gateway.engine.pool.num_used == 0
        assert gateway.scheduler.num_active == 0
    finally:
        gateway.shutdown()


def test_backpressure_503_when_pipeline_full(tiny_ralm):
    """max_queue_depth=1: with one request in flight, the next offer is
    a bounded 503 + Retry-After instead of unbounded queueing."""
    gateway = Gateway(_engine(tiny_ralm), GatewayConfig(max_queue_depth=1))
    gateway.start_background()
    try:
        prompt = tiny_ralm["corpus"][6, :8].tolist()
        s1, status1, _, rest1 = _post(
            gateway.port,
            {"prompt": prompt, "max_tokens": 40, "stream": True})
        assert status1 == 200
        buf = rest1
        while b"\n\n" not in buf:              # request 1 is live
            data = s1.recv(4096)
            assert data
            buf += data
        s2, status2, headers2, _ = _post(
            gateway.port, {"prompt": prompt, "max_tokens": 1})
        s2.close()
        assert status2 == 503
        assert int(headers2["retry-after"]) >= 1
        assert gateway.admission.rejected_capacity >= 1
        _drain_sse(s1, buf)
    finally:
        gateway.shutdown()


def test_string_prompt_toy_codec(gw, tiny_ralm):
    """OpenAI-style string prompts ride the documented byte codec."""
    s, status, _, rest = _post(gw.port, {"prompt": "hello", "max_tokens": 2})
    obj = json.loads(_read_all(s, rest))
    assert status == 200
    ref_prompt = [ord(c) % 64 for c in "hello"]
    toks = [int(t) for t in obj["choices"][0]["text"].split()]
    assert toks == _greedy_ref(tiny_ralm, ref_prompt, 2)


def test_cancel_finds_a_request_behind_others(tiny_ralm):
    """Cancelling a queued request that others precede: the port removes
    it by position (``deque.remove`` would compare the requests' prompt
    tensors and raise)."""
    ctl = AdmissionController(max_queue_depth=10)
    for rid in range(3):
        ctl.offer(_req("a", rows=2, rid=rid))
    assert ctl.cancel(2) and ctl.pending == 2
    assert [ctl.take(lambda r: True).request_id for _ in range(2)] == [0, 1]
    eng = _engine(tiny_ralm, kv_slots=2)
    rids = [eng.submit(RalmRequest(
        prompt=torch.from_numpy(tiny_ralm["corpus"][i:i + 2, :8]), steps=2))
        for i in range(3)]
    assert eng.scheduler.cancel(rids[2])
    assert [r.request_id for r in eng.scheduler.queue] == rids[:2]


def test_scheduler_cancel_and_queue_stats(tiny_ralm):
    """Queue depth / age / tenant stats and cancel, driven in-process."""
    eng = _engine(tiny_ralm, kv_slots=1)
    corpus = tiny_ralm["corpus"]
    r1 = RalmRequest(prompt=torch.from_numpy(corpus[:1, :8]), steps=3,
                     tenant="a")
    r2 = RalmRequest(prompt=torch.from_numpy(corpus[1:2, :8]), steps=3,
                     tenant="b")
    eng.submit(r1)
    eng.submit(r2)
    assert r1.trace_id == r1.request_id           # defaulted at submit
    st = eng.scheduler.queue_stats()
    assert st["queued_requests"] == 2 and st["active_requests"] == 0
    assert st["tenant_depth"] == {"a": 1, "b": 1}
    assert st["queue_age_max_s"] >= 0.0
    eng.step()                                  # r1 starts (1 slot)
    assert eng.scheduler.queued_requests == 1
    assert eng.scheduler.cancel(r2.request_id)  # queued: dropped now
    assert eng.scheduler.queued_requests == 0
    assert eng.scheduler.cancel(r1.request_id)  # active: flagged
    (resp,) = eng.step()                        # cleaned up next step
    assert resp.cancelled and resp.request_id == r1.request_id
    assert resp.tenant == "a"
    assert eng.pool.num_used == 0
    assert not eng.scheduler.cancel(999)


# ---------------------------------------------------------------------------
# the port's own serving cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["staged", "per_sequence"])
def test_http_streaming_parity_other_engines(tiny_ralm, kind):
    """The gateway over a staged-scan engine and over a per-sequence
    engine (no KV pool: admission is not bounded by free rows) streams
    the JAX engine's greedy tokens too."""
    eng = (_engine(tiny_ralm, fused=False) if kind == "staged" else
           _engine(tiny_ralm, wave=False, kv_slots=None))
    gateway = Gateway(eng, GatewayConfig())
    gateway.start_background()
    try:
        assert (gateway._free_rows() is None) == (kind == "per_sequence")
        prompt = tiny_ralm["corpus"][7, :8].tolist()
        s, status, _, rest = _post(
            gateway.port, {"prompt": prompt, "max_tokens": 5,
                           "stream": True})
        assert status == 200
        toks, final = _drain_sse(s, rest)
        assert final["choices"][0]["finish_reason"] == "length"
        assert toks == _greedy_ref(tiny_ralm, prompt, 5)
    finally:
        gateway.shutdown()
    assert eng.pool is None if kind == "per_sequence" else \
        eng.pool.num_used == 0


def test_gateway_run_leaves_no_autograd_graph(tiny_ralm):
    """Grad mode is per thread: the step thread must run every forward
    under no_grad. With parameters that require grad, no tensor the
    gateway's run leaves behind (the pool caches, the first token's
    logits path) carries a grad_fn."""
    t = tiny_ralm
    params = {k: v for k, v in t["tparams"].items()}
    params["embed"] = params["embed"].clone().requires_grad_(True)
    params["classes"] = {
        cls: {name: a.clone().requires_grad_(a.is_floating_point())
              for name, a in leaves.items()}
        for cls, leaves in t["tparams"]["classes"].items()}
    ccfg = t["tds"].search_config(nprobe=4, k=8)
    eng = RalmEngine.monolithic(params, t["tcfg"], t["trag"],
                                t["tds"].retriever(ccfg), max_seq=64,
                                kv_slots=8, attn_seq_block=64)
    seen = []
    decode_wave = eng.backend.decode_wave

    def recording(*a, **k):
        out = decode_wave(*a, **k)
        seen.extend([out[0], out[2]])
        return out

    eng.backend.decode_wave = recording
    gateway = Gateway(eng, GatewayConfig())
    gateway.start_background()
    try:
        prompt = t["corpus"][8, :8].tolist()
        s, status, _, rest = _post(
            gateway.port, {"prompt": prompt, "max_tokens": 3,
                           "stream": True})
        assert status == 200
        toks, _ = _drain_sse(s, rest)
    finally:
        gateway.shutdown()
    assert toks == _greedy_ref(t, prompt, 3)
    leaves = [a for c in eng.pool.caches["classes"].values()
              for a in c.values()]
    assert seen and all(x.grad_fn is None and not x.requires_grad
                        for x in seen + leaves)
