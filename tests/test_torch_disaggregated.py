"""The port's disaggregated engine on the CPU: an LM pool (this process)
and memory-node processes over gloo.

  * the router pipeline under the chaos matrix
    (``tests/test_chaos.py::test_chaos_seed_matrix_router_pipeline``):
    one fault domain; a crashed or hung replica fails over with
    bit-identical results; losing every replica serves ``(+inf, -1)``;
  * ``tests/test_serve.py::test_monolithic_disaggregated_parity``'s
    fixture (reduced Dec-S, vocab 64, 1 LM + 2 memory nodes, two
    pipelined batches, 8 steps): the port's disaggregated greedy tokens
    equal the port's monolithic tokens and the JAX monolithic engine's;
  * ``PoolTimes``, ``from_config(disaggregate=True)`` and its warnings,
    the ``lm_devices`` rule, the launcher's ``--disaggregate``;
  * lifetime: no node process outlives ``close()``, an exception in a
    ``with`` block, a node that raises, a node that dies, a node that
    stops answering (the coordinator's wait times out), or a coordinator
    that dies without closing.
"""
import dataclasses
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import ivfpq as jivf
from repro.models import transformer as jtf
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro_torch import convert
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.retrieval import (Fabric, FabricError, FailoverConfig,
                                   FaultPlan, FaultSpec, RetrievalService,
                                   ServiceConfig, ShardRouter)
from repro_torch.serve import (DisaggregatedBackend, DistributedRetriever,
                               EngineConfig, RagConfig, RalmEngine)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.array(x)


def _gone(pids):
    """Whether every pid has exited (and been reaped)."""
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


# ---------------------------------------------------------------------------
# the router pipeline under chaos
# ---------------------------------------------------------------------------

def test_chaos_seed_matrix_router_pipeline():
    """One router (4 x 2 memory nodes) under four services: the pipeline
    is one fault domain; crash and hang on one of two replicas fail over
    to bit-identical results; losing every replica is a partial result
    with live fraction 0, all ids -1 and all distances +inf."""
    key = jax.random.PRNGKey(0)
    icfg = jivf.IVFPQConfig(dim=64, nlist=64, m=8, list_cap=128)
    vecs = jax.random.normal(key, (8192, 64))
    params = jivf.train_ivfpq(key, vecs[:4096], icfg, kmeans_iters=6)
    shards = jivf.build_shards(params, np.asarray(vecs), icfg, num_shards=4)
    tparams = convert.ivfpq_params(_np(params.coarse_centroids),
                                   _np(params.codebooks))
    tshards = convert.ivfpq_shards(
        [(_np(s.codes), _np(s.ids), _np(s.list_len)) for s in shards])
    cfg = ChamVSConfig(ivfpq=convert.index_config(dataclasses.asdict(icfg)),
                       nprobe=16, k=20)
    q = torch.from_numpy(_np(jax.random.normal(jax.random.PRNGKey(1),
                                               (4, 64))))
    mesh = make_mesh_for(data=4, model=2, device="cpu")
    with ShardRouter(mesh, cfg, db_axes=("data",),
                     query_axis="model") as router:
        def svc(failover=None, plan=None):
            s = RetrievalService.distributed(
                router, tparams, tshards,
                ServiceConfig(bucket_pow2=False, failover=failover))
            if plan is not None:
                s.install_chaos(plan)
            return s

        def search(s):
            h = s.submit(q)
            s.flush()
            d, i = h.result()
            return d, i, h

        base = svc()
        assert base.pipeline.fault_domains == 1
        d0, i0, _ = search(base)
        assert torch.isfinite(d0).all() and (i0 >= 0).all()
        fo = FailoverConfig(replicas=2, probation_s=999.0)
        for kind in ("crash", "hang"):
            s = svc(fo, FaultPlan.make([FaultSpec(kind=kind, replica=1)]))
            d1, i1, h = search(s)
            assert torch.equal(d0, d1) and torch.equal(i0, i1), kind
            assert not h.partial, kind
        s = svc(fo, FaultPlan.make([FaultSpec(kind="crash", replica=-1)]))
        d2, i2, h2 = search(s)
        assert h2.partial and h2.live_fraction == 0.0
        assert (i2 == -1).all() and torch.isinf(d2).all()
        pids = router.fabric.pids
    assert _gone(pids)


# ---------------------------------------------------------------------------
# the parity fixture
# ---------------------------------------------------------------------------

def _corpus():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        seqs.append((3 * seqs[-1] + 1) % 64)
    return np.stack(seqs, axis=1).astype(np.int32), rng


@pytest.fixture(scope="module")
def ralm():
    """``test_monolithic_disaggregated_parity``'s recipe, built by the
    reference and converted: params, a 2-shard kNN-LM datastore, the
    search config and the two prompt batches (memorized and fresh)."""
    cfg = dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    corpus, rng = _corpus()
    ds = JaxBuilder(dim=cfg.d_model, nlist=8, m=8,
                    list_cap=512).from_corpus(params, cfg, corpus)
    rag = JaxRagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                       temperature=1.0)
    prompts = [corpus[:4, :8],
               rng.integers(0, 64, size=(2, 8), dtype=np.int32)]
    tcfg = convert.model_config(dataclasses.asdict(cfg))
    tparams = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), params),
        tcfg)
    tds = convert.datastore(
        dataclasses.asdict(ds.index_cfg), _np(ds.params.coarse_centroids),
        _np(ds.params.codebooks),
        [(_np(s.codes), _np(s.ids), _np(s.list_len)) for s in ds.shards],
        payload_tokens=_np(ds.payload_tokens), num_vectors=ds.num_vectors)
    return dict(cfg=cfg, params=params, ds=ds, rag=rag, corpus=corpus,
                prompts=prompts, tcfg=tcfg, tparams=tparams, tds=tds,
                trag=RagConfig(**dataclasses.asdict(rag)),
                tccfg=tds.search_config(nprobe=4, k=8))


def test_monolithic_disaggregated_parity(ralm):
    """1 LM + 2 memory nodes: the disaggregated engine's greedy tokens
    equal the port's monolithic engine's and the JAX monolithic
    engine's, for fresh and memorized prompts pipelined together; the
    model still continues the corpus; both pools' times are recorded;
    each node served the searches, and gathered every wave's payload."""
    t = ralm
    jeng = JaxEngine.monolithic(
        t["params"], t["cfg"], t["rag"],
        retriever=t["ds"].retriever(t["ds"].search_config(
            nprobe=4, k=8, backend="ref")))
    out_j = jeng.generate_batches([jnp.asarray(p) for p in t["prompts"]],
                                  steps=8)
    tprompts = [torch.from_numpy(p) for p in t["prompts"]]
    mono = RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"],
                                 retriever=t["tds"].retriever(t["tccfg"]))
    out_m = mono.generate_batches(tprompts, steps=8)
    with RalmEngine.disaggregated(
            t["tparams"], t["tcfg"], t["trag"], t["tds"].params,
            t["tds"].shards, t["tccfg"],
            payload_tokens=t["tds"].payload_tokens, lm_devices=1,
            ret_devices=2) as dis:
        assert dis.backend.lm_mesh.size == 1
        assert dis.backend.ret_mesh.size == 2
        assert dis.backend.ret_mesh.devices == ("cpu", "cpu")
        out_d = dis.generate_batches(tprompts, steps=8)
        fabric = dis.retriever.router.fabric
        stats = fabric.stats()
        times = dis.times
        pids = fabric.pids
    assert _gone(pids)
    for j, m, d in zip(out_j, out_m, out_d):
        np.testing.assert_array_equal(m, _np(j))
        np.testing.assert_array_equal(d, m)
    assert (out_d[0][:, 8:] == t["corpus"][:4, 8:16]).mean() > 0.8
    assert len(times.decode_s) > 0 and len(times.search_s) > 0
    assert np.isfinite(times.optimal_ratio())
    searches = fabric.counters["search"].round_trips
    assert searches == len(times.search_s) == 8
    assert [s["searches"] for s in stats] == [searches] * 2
    assert [s["gathers"] for s in stats] == [searches] * 2


def test_from_config_disaggregate(ralm):
    """``from_config(disaggregate=True)`` serves disaggregated on one
    device kind (no monolithic fallback), warning that async retrieval
    and speculation are not wired in; tokens equal the monolithic
    engine's from the same config; ``PoolTimes`` fill."""
    t = ralm
    econfig = EngineConfig(model=t["tcfg"], rag=t["trag"], disaggregate=True,
                           ret_devices=2, async_retrieval=True,
                           speculate_k=1)
    with pytest.warns(RuntimeWarning) as rec:
        eng = RalmEngine.from_config(econfig, t["tparams"], t["tds"],
                                     t["tccfg"], device="cpu")
    msgs = " ".join(str(w.message) for w in rec)
    assert "async_retrieval" in msgs and "speculate_k" in msgs
    with eng:
        assert isinstance(eng.backend, DisaggregatedBackend)
        assert isinstance(eng.retriever, DistributedRetriever)
        assert eng.speculate_k == 0
        out_d = eng.generate_batches([torch.from_numpy(t["prompts"][0])],
                                     steps=4)
        assert len(eng.times.decode_s) == 3 and len(eng.times.search_s) == 4
        assert eng.times.optimal_ratio() > 0
    mono = RalmEngine.from_config(
        dataclasses.replace(econfig, disaggregate=False,
                            async_retrieval=False, speculate_k=0),
        t["tparams"], t["tds"], t["tccfg"], device="cpu")
    assert mono.times is None
    out_m = mono.generate_batches([torch.from_numpy(t["prompts"][0])],
                                  steps=4)
    np.testing.assert_array_equal(out_d[0], out_m[0])


def test_lm_devices_must_be_one(ralm):
    """The LM pool shards nothing, so ``lm_devices`` other than 1 raises,
    before any node starts."""
    t = ralm
    econfig = EngineConfig(model=t["tcfg"], rag=t["trag"], disaggregate=True,
                           lm_devices=2, ret_devices=2)
    with pytest.raises(ValueError, match="lm_devices=2"):
        RalmEngine.from_config(econfig, t["tparams"], t["tds"], t["tccfg"],
                               device="cpu")


def test_node_error_raises_and_leaves_no_process(ralm):
    """A node that raises (queries of the wrong width) makes the
    coordinator raise with the node's error text, with no fallback; the
    fabric stays usable. An exception escaping the ``with`` block closes
    the engine, and no node process is left."""
    t = ralm
    pids = []
    with pytest.raises(KeyError, match="escaped"):
        with RalmEngine.disaggregated(
                t["tparams"], t["tcfg"], t["trag"], t["tds"].params,
                t["tds"].shards, t["tccfg"],
                payload_tokens=t["tds"].payload_tokens,
                ret_devices=2) as eng:
            fabric = eng.retriever.router.fabric
            pids = fabric.pids
            with pytest.raises(FabricError, match="memory node 1"):
                eng.retriever.search(torch.zeros(2, t["tcfg"].d_model + 1))
            assert all(fabric.alive()) and not fabric.closed
            d, i = eng.retriever.search(torch.zeros(2, t["tcfg"].d_model))
            assert d.shape == i.shape == (2, 8)
            raise KeyError("escaped")
    assert len(pids) == 2 and _gone(pids)


def test_dead_or_silent_node_closes_the_fabric():
    """A node killed mid-life: the next call raises and closes the fabric
    (its sibling reaped). A node that stops answering: the coordinator's
    wait ends at ``timeout_s``, it raises, and the fabric is closed."""
    f = Fabric(["cpu", "cpu"])
    assert [s["device_name"] for s in f.stats()] == ["cpu", "cpu"]
    os.kill(f.pids[0], signal.SIGKILL)
    with pytest.raises(FabricError, match="closed"):
        f.stats()
    assert f.closed and _gone(f.pids)

    f = Fabric(["cpu"], timeout_s=1.0)
    os.kill(f.pids[0], signal.SIGSTOP)
    t0 = time.monotonic()
    with pytest.raises(FabricError):
        f.stats()
    assert time.monotonic() - t0 < 30
    assert f.closed and _gone(f.pids)


def test_nodes_exit_when_the_coordinator_dies():
    """A coordinator process that dies without closing its fabric leaves
    no node behind: each node sees its connection close (or its parent
    gone) and exits."""
    code = ("import os; from repro_torch.retrieval.fabric import Fabric; "
            "f = Fabric(['cpu', 'cpu']); print(*f.pids, flush=True); "
            "os._exit(3)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode == 3, p.stderr
    pids = [int(x) for x in p.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not all(
            _exited(pid) for pid in pids):
        time.sleep(0.2)
    assert all(_exited(pid) for pid in pids)


def _exited(pid: int) -> bool:
    """True when ``pid`` (not our child) is gone or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_launcher_disaggregate_on_cpu():
    """``python -m repro_torch.launch.serve --device cpu --reduced
    --disaggregate`` serves both batches and reports the pools and the
    fabric."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--disaggregate", "--steps", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "2 batches" in p.stdout and "LM dispatches on cpu" in p.stdout
    assert "[serve] pools:" in p.stdout
    assert "fabric search: 4 round trips" in p.stdout
    assert "2 memory nodes" in p.stdout
