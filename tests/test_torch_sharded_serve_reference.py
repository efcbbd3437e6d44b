"""The port's sharded prefill and serve steps against the reference's
GSPMD steps at 2 x 2 (reduced models in float32 on the CPU):

  * the reference: a subprocess with 4 forced host devices builds
    ``repro.launch.steps.build_prefill_step`` and ``build_serve_step`` at
    ``make_mesh_for(data=2, model=2)`` (its ``SHAPES`` given two small
    entries in that process; no file of the reference changes), places
    the params (``PRNGKey(0)``), caches, inputs, index (its
    ``train_ivfpq`` / ``build_shards``, one shard per data coordinate)
    and payload by ``put_named`` of the returned specs, and runs the
    prefill step and 3 serve steps, and its distributed search
    (``router.build_search``) on seeded queries. Cases: Dec-S and
    EncDec-S at a batch of 8 (K/V rows over "data", the sequence over
    "model", the query split) and Dec-S at a batch of 1 (the sequence
    over data x model, the probe split);
  * the port: 4 gloo ranks (``launch.dp``, the entry
    ``tests/torch_serve_ranks.py``) run the port's builders with their
    rank group from the same params, index, payload and inputs, each on
    the shards ``put_named`` gives it, and the mesh search on the same
    queries;
  * logits of every step within 1e-5 relative / 1e-5 absolute, search
    ids exact and distances within 1e-5 relative, and the caches,
    gathered back with ``gather_named``, within the same bound.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core.ivfpq import IVFPQShard
from repro_torch.launch import dp

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
REL = dict(rtol=1e-5, atol=1e-5)
CASES = [("dec_s", 8), ("encdec_s", 8), ("dec_s", 1)]
S, T0, STEPS = 32, 16, 3                  # cache, prompt, serve steps
DB = dict(n_vectors=4096, nlist=16, nprobe=4)
N_VEC = 2048

REFERENCE = '''
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
import repro.configs as jconfigs
from repro.compat import use_mesh
from repro.configs import get_arch
from repro.core import ivfpq
from repro.core.chamvs import stack_shards
from repro.launch import specs, steps
from repro.launch.mesh import make_mesh_for
from repro.models import transformer as tf
from repro.models.sharding import put_named, sanitize
from repro.retrieval import router
out = sys.argv[1]
cases, S, T0, STEPS, DB, N_VEC = json.loads(sys.argv[2])
mesh = make_mesh_for(data=2, model=2)
results = []
for n, (arch, B) in enumerate(cases):
    jconfigs.SHAPES["prefill_case"] = dict(kind="prefill", seq_len=S,
                                           global_batch=B)
    jconfigs.SHAPES["decode_case"] = dict(kind="decode", seq_len=S,
                                          global_batch=B)
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.reduced, dtype="float32")
    spec = dataclasses.replace(spec, model=cfg)
    rng = np.random.default_rng(10 + n)
    params = tf.init_params(jax.random.PRNGKey(0), cfg)
    enc = spec.rag.k * spec.rag.chunk_len if cfg.arch == "encdec" else 0
    pre = {"tokens": rng.integers(0, cfg.vocab_size, (B, T0)).astype(np.int32),
           "positions": np.broadcast_to(np.arange(T0, dtype=np.int32),
                                        (B, T0)).copy()}
    if enc:
        pre["enc_embeds"] = rng.standard_normal(
            (B, enc, cfg.d_model)).astype(np.float32)
    dec = []
    for s in range(STEPS):
        b = {"token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
             "position": np.full((B,), T0 + s, np.int32)}
        if enc:
            b["enc_states"] = rng.standard_normal(
                (B, enc, cfg.d_model)).astype(np.float32)
        dec.append(b)
    with use_mesh(mesh):
        pstep, (p_specs, c_specs, b_specs) = steps.build_prefill_step(
            spec, "prefill_case", mesh)
        sstep, shardings, (ccfg, structs) = steps.build_serve_step(
            spec, "decode_case", mesh, db=specs.ServeDBSpec(**DB))
        vecs = rng.standard_normal((N_VEC, ccfg.ivfpq.dim)).astype(np.float32)
        dbp = ivfpq.train_ivfpq(jax.random.PRNGKey(0), jnp.asarray(vecs),
                                ccfg.ivfpq, kmeans_iters=4)
        stacked = stack_shards(ivfpq.build_shards(dbp, vecs, ccfg.ivfpq, 2))
        payload = (rng.integers(0, cfg.vocab_size, (DB["n_vectors"],))
                   if spec.rag.mode == "knnlm" else
                   rng.integers(0, cfg.vocab_size,
                                (DB["n_vectors"], spec.rag.chunk_len))
                   ).astype(np.int32)
        queries = rng.standard_normal((B, ccfg.ivfpq.dim)).astype(np.float32)
        caches = tf.init_cache(cfg, B, S, enc_len=enc)
        place = lambda t, k: put_named(t, sanitize(shardings[k], structs[k],
                                                   mesh), mesh)
        logits, caches = pstep(put_named(params, p_specs, mesh),
                               put_named(caches, c_specs, mesh),
                               put_named({k: jnp.asarray(v)
                                          for k, v in pre.items()},
                                         b_specs, mesh))
        rec = {"prefill": np.array(logits), "serve": []}
        P_ = put_named(params, p_specs, mesh)
        for b in dec:
            lp, caches = sstep(P_, caches,
                               place({k: jnp.asarray(v) for k, v in b.items()},
                                     "batch"),
                               place(dbp, "db_params"),
                               place(stacked, "db_shard"),
                               place(jnp.asarray(payload), "payload"))
            rec["serve"].append(np.array(lp))
        search = jax.jit(router.build_search(mesh, ccfg, db_axes=("data",),
                                             query_axis="model", nq=B))
        d, i = search(place(dbp, "db_params"), place(stacked, "db_shard"),
                      jnp.asarray(queries))
    rec.update(
        search=(np.array(d), np.array(i)), queries=queries,
        caches=[np.array(x) for x in jax.tree.leaves(caches)],
        params=[np.array(x) for x in jax.tree.leaves(params)],
        db=(np.array(dbp.coarse_centroids), np.array(dbp.codebooks),
            np.array(stacked.codes), np.array(stacked.ids),
            np.array(stacked.list_len)),
        payload=payload, pre=pre, dec=dec)
    results.append(rec)
with open(out, "wb") as f:
    pickle.dump(results, f)
'''


def _reference(tmp: pathlib.Path):
    import pickle
    env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", HOME=str(tmp), OMP_NUM_THREADS="2")
    out = tmp / "ref.pkl"
    p = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        json.dumps([CASES, S, T0, STEPS, DB, N_VEC])],
                       capture_output=True, text=True, timeout=400, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _case(arch, B, ref):
    """The port's case (``torch_serve_ranks``) from the reference's
    params, index, payload and inputs."""
    jspec = jax_arch(arch)
    import dataclasses
    jcfg = dataclasses.replace(jspec.reduced, dtype="float32")
    tree = jax.tree.unflatten(jax.tree.structure(jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))), ref["params"])
    import torch_serve_ranks
    cfg = torch_serve_ranks.spec_of(arch).model
    cents, books, codes, ids, lens = ref["db"]
    return dict(
        arch=arch, params=convert.lm_params(tree, cfg),
        shapes=dict(prefill=dict(seq_len=S, global_batch=B),
                    decode=dict(seq_len=S, global_batch=B)),
        db=DB, db_params=convert.ivfpq_params(cents, books),
        db_shard=IVFPQShard(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (codes, ids, lens))),
        payload=torch.from_numpy(ref["payload"]), prefill=_t(ref["pre"]),
        steps=[_t(b) for b in ref["dec"]],
        queries=torch.from_numpy(ref["queries"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    refs = _reference(tmp)
    cases = [_case(a, B, r) for (a, B), r in zip(CASES, refs)]
    torch.save(cases, tmp / "cases.pt")
    dp.launch(4, "torch_serve_ranks:run", [str(tmp / "cases.pt"), str(tmp)],
              device="cpu", timeout_s=300, model=2)
    return refs, torch.load(tmp / "result.pt", weights_only=False)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "")
                        .split(os.pathsep) if p]))
    mp.setenv("OMP_NUM_THREADS", "1")
    yield mp
    mp.undo()


@pytest.mark.parametrize("n", range(len(CASES)),
                         ids=[f"{a}_b{B}" for a, B in CASES])
def test_logits_match_the_gspmd_steps(runs, n):
    refs, got = runs
    np.testing.assert_allclose(got[n]["prefill"].numpy(), refs[n]["prefill"],
                               **REL)
    assert len(got[n]["serve"]) == STEPS
    for mine, want in zip(got[n]["serve"], refs[n]["serve"]):
        np.testing.assert_allclose(mine.numpy(), want, **REL)


@pytest.mark.parametrize("n", range(len(CASES)),
                         ids=[f"{a}_b{B}" for a, B in CASES])
def test_search_matches_the_distributed_search(runs, n):
    refs, got = runs
    d, i = got[n]["queries_search"]
    d0, i0 = refs[n]["search"]
    np.testing.assert_array_equal(i.numpy(), i0)
    np.testing.assert_allclose(d.numpy(), d0, rtol=1e-5)


@pytest.mark.parametrize("n", range(len(CASES)),
                         ids=[f"{a}_b{B}" for a, B in CASES])
def test_caches_gathered_match(runs, n):
    refs, got = runs
    mine = tree_lib.leaves(got[n]["caches"])
    want = refs[n]["caches"]
    assert [tuple(t.shape) for t in mine] == [w.shape for w in want]
    for t, w in zip(mine, want):
        np.testing.assert_allclose(t.numpy(), w, **REL)
