"""Rank entry of the sharded serving tests (``launch.dp.launch(...,
"torch_serve_ranks:run", [cases_file, out_dir])``; the tests put this
directory on the ranks' ``PYTHONPATH``), and the same steps in one
process.

A case (a dict, ``torch.save``d in a list) names a reduced model
(``arch``), its float32 parameters (``params``, whole), the shapes of
its prefill and decode steps (``shapes``: registered in ``SHAPES`` under
``prefill_case`` / ``decode_case``), the index (``db``: the
``ServeDBSpec`` fields; ``db_params``, the stacked ``db_shard`` with one
shard per data rank, ``payload``), the prefill batch and one batch per
serve step (and, as ``queries``, a batch of queries for the search
alone). ``run_case`` puts every input in place with ``put_named`` of
the builders' specs, runs the prefill step and the serve steps, and
returns whole tensors (``gather_named`` under the reference's out
specs): each step's logits, each search's query and (dists, ids), the
final caches, and this rank's held bytes, collective stats and kernel
launches.
"""
import contextlib
import dataclasses
import pathlib

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import SHAPES, get_arch
from repro_torch.kernels import _build
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import (P, dp_axes, gather_named,
                                         put_named, sanitize)


def spec_of(arch: str, dtype: str = "float32"):
    spec = get_arch(arch)
    return dataclasses.replace(spec, model=dataclasses.replace(
        spec.reduced, dtype=dtype))


def n_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree))


@contextlib.contextmanager
def _case_shapes(case):
    """The case's shapes registered in ``SHAPES`` as ``prefill_case`` /
    ``decode_case`` while it runs (a test process's other tests walk
    ``SHAPES``)."""
    names = {"prefill_case": "prefill", "decode_case": "decode"}
    saved = {name: SHAPES.get(name) for name in names}
    for name, kind in names.items():
        SHAPES[name] = dict(case["shapes"][kind], kind=kind)
    try:
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                SHAPES.pop(name, None)
            else:
                SHAPES[name] = old


def run_case(group, case, mesh=None, queries=None):
    """The case on ``group`` (a one-rank group runs the one-position
    steps); returns whole tensors on every rank. ``queries``: one per
    serve step, searched instead of the step's own (to hold one device's
    steps to another's, whose hidden states round apart)."""
    with _case_shapes(case):
        return _run_case(group, case, mesh, queries)


def _run_case(group, case, mesh, queries):
    spec = spec_of(case["arch"], case.get("dtype", "float32"))
    cfg = spec.model
    mesh = mesh or group.mesh
    g = group if group.size > 1 else None
    B = SHAPES["decode_case"]["global_batch"]
    S = SHAPES["decode_case"]["seq_len"]
    prefill, (p_specs, c_specs, b_specs) = steps_lib.build_prefill_step(
        spec, "prefill_case", mesh, group=g)
    serve, shardings, (ccfg, structs) = steps_lib.build_serve_step(
        spec, "decode_case", mesh, db=specs_lib.ServeDBSpec(**case["db"]),
        group=g)
    held = {k: sanitize(shardings[k], structs[k], mesh)
            for k in ("batch", "db_params", "db_shard", "payload")}
    dev = group.device

    def put(tree, specs):
        return put_named(tree, specs, mesh, group) if g else \
            tree_lib.map(lambda t: t.to(dev), tree)

    def whole(tree, specs):
        return gather_named(tree, specs, mesh, group) if g else tree

    enc = spec.rag.k * spec.rag.chunk_len if cfg.arch == "encdec" else 0
    params = put(case["params"], p_specs)
    caches = put(tf.init_cache(cfg, B, S, enc_len=enc), c_specs)
    dbp = put(case["db_params"], held["db_params"])
    dbs = put(case["db_shard"], held["db_shard"])
    payload = put(case["payload"], held["payload"])
    resident = n_bytes((params, caches, dbp, dbs, payload))
    search, found, asked = serve.search, [], []

    def recording(dbp_, dbs_, q):
        if queries is not None:
            q = queries[len(found)].to(q.device)
        asked.append(q)
        found.append(search(dbp_, dbs_, q))
        return found[-1]

    serve.search = recording
    dp = dp_axes(mesh)
    logit_spec = sanitize(P(dp, "model"), specs_lib.S((B, cfg.vocab_size),
                                                      torch.float32), mesh)
    serve_spec = sanitize(P(dp if B >= 8 else None, "model"),
                          specs_lib.S((B, cfg.vocab_size), torch.float32),
                          mesh)
    _build.reset_launches()
    logits, caches = prefill(params, caches,
                             put(case["prefill"], b_specs))
    out = {"prefill": whole(logits, logit_spec), "serve": [], "stats": []}
    if prefill.stats is not None:
        out["stats"].append(prefill.stats())
    for batch in case["steps"]:
        logp, caches = serve(params, caches, put(batch, held["batch"]),
                             dbp, dbs, payload)
        out["serve"].append(whole(logp, serve_spec))
        if serve.stats is not None:
            out["stats"].append(serve.stats())
    serve.search = search
    out["search"], out["queries"] = found, asked
    out["launches"] = {k: kern.launches
                       for k, kern in _build.kernels().items()}
    if "queries" in case:
        out["queries_search"] = search(
            dbp, dbs, case["queries"].to(dev))
    out["caches"] = whole(caches, c_specs)
    out["resident"] = resident
    return out


def run(group, argv):
    cases = torch.load(argv[0], weights_only=False)
    results = [run_case(group, case) for case in cases]
    if group.rank == 0:
        torch.save(results, pathlib.Path(argv[1]) / "result.pt")
