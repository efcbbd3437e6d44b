"""The reference's GSPMD prefill and serve steps at 2 x 2 and the port's
sharded steps on the same inputs: the helpers of the
``test_torch_sharded_serve_*`` parity tests (reduced models in float32
on the CPU).

  * ``reference``: a subprocess with 4 forced host devices builds
    ``repro.launch.steps.build_prefill_step`` and ``build_serve_step`` at
    ``make_mesh_for(data=2, model=2)`` (its ``SHAPES`` given two small
    entries in that process; no file of the reference changes), places
    the params (``PRNGKey(0)``), caches, inputs (a case's
    ``prompt_vocab`` draws the prompts' tokens from that many ids only),
    index (its ``train_ivfpq`` / ``build_shards``, one shard per data
    coordinate) and payload by ``put_named`` of the returned specs, and
    runs the prefill step and 3 serve steps, and its distributed search
    (``router.build_search``) on seeded queries;
  * ``run_port``: 4 gloo ranks (``launch.dp``, the entry
    ``tests/torch_serve_ranks.py``) run the port's builders with their
    rank group from the same params, index, payload and inputs, each on
    the shards ``put_named`` gives it, and the mesh search on the same
    queries;
  * ``check_logits`` / ``check_caches`` / ``check_search``: logits of
    every step and the caches gathered back with ``gather_named`` within
    1e-5 relative / 1e-5 absolute (or, given a range tolerance, within
    it times each tensor's largest magnitude), search
    ids exact and distances within 1e-5 relative.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_serve_ranks
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core.ivfpq import IVFPQShard
from repro_torch.launch import dp

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
REL = dict(rtol=1e-5, atol=1e-5)
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
for n, (arch, B, opts) in enumerate(cases):
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
    pre = {"tokens": rng.integers(0, opts.get("prompt_vocab", cfg.vocab_size),
                                  (B, T0)).astype(np.int32),
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


def reference(tmp: pathlib.Path, cases):
    """The reference's records of ``cases`` ((arch, B, options) each),
    run in a subprocess with 4 forced host devices."""
    import pickle
    env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", HOME=str(tmp), OMP_NUM_THREADS="2")
    out = tmp / "ref.pkl"
    p = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        json.dumps([cases, S, T0, STEPS, DB, N_VEC])],
                       capture_output=True, text=True, timeout=400, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def port_case(arch, B, ref):
    """The port's case (``torch_serve_ranks``) from the reference's
    params, index, payload and inputs."""
    jspec = jax_arch(arch)
    jcfg = dataclasses.replace(jspec.reduced, dtype="float32")
    tree = jax.tree.unflatten(jax.tree.structure(jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))), ref["params"])
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


def run_port(tmp: pathlib.Path, cases, refs):
    """Every rank-0 result of ``cases`` on 4 gloo ranks at 2 x 2."""
    saved = [port_case(a, B, r) for (a, B, _), r in zip(cases, refs)]
    torch.save(saved, tmp / "cases.pt")
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "")
                        .split(os.pathsep) if p]))
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        dp.launch(4, "torch_serve_ranks:run", [str(tmp / "cases.pt"),
                                               str(tmp)],
                  device="cpu", timeout_s=300, model=2)
    finally:
        mp.undo()
    return torch.load(tmp / "result.pt", weights_only=False)


def runs(tmp: pathlib.Path, cases):
    """(the reference's records, the port's results) of ``cases``."""
    refs = reference(tmp, cases)
    return refs, run_port(tmp, cases, refs)


def _close(mine: np.ndarray, want: np.ndarray, range_tol, msg=""):
    if range_tol is None:
        np.testing.assert_allclose(mine, want, **REL, err_msg=msg)
    else:
        err = np.abs(mine - want).max()
        assert err <= range_tol * np.abs(want).max(), (msg, err)


def check_logits(ref, got, range_tol=None) -> None:
    _close(got["prefill"].numpy(), ref["prefill"], range_tol, "prefill")
    assert len(got["serve"]) == STEPS
    for s, (mine, want) in enumerate(zip(got["serve"], ref["serve"])):
        _close(mine.numpy(), want, range_tol, f"serve step {s}")


def check_caches(ref, got, range_tol=None) -> None:
    mine = tree_lib.keyed(got["caches"])
    want = ref["caches"]
    assert [tuple(t.shape) for t in mine.values()] == [w.shape for w in want]
    for (key, t), w in zip(mine.items(), want):
        _close(t.numpy(), w, range_tol, key)


def check_search(ref, got) -> None:
    d, i = got["queries_search"]
    d0, i0 = ref["search"]
    np.testing.assert_array_equal(i.numpy(), i0)
    np.testing.assert_allclose(d.numpy(), d0, rtol=1e-5)
