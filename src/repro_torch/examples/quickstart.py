"""Quickstart: build a ChamVS index, search it, check recall (twin of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cuda|cpu]

Five steps, through the ``repro_torch.serve`` surface: a clustered
16 384 x 64 database from a seeded ``torch.Generator``; a
``DatastoreBuilder`` index (IVF-PQ, 64 lists, m 16) striped over 4
memory-node shards; a search through the ``Retriever`` protocol, the
call the serving engine makes; R10@32 against ``exact_search``; and the
same search on the CPU: the card's kernels (IVF probe, fused scan)
agree with their plain versions, distances within 1e-5 relative and
ids identical but where two distances tie within that (the two devices'
LUT GEMMs round differently; ``ivfpq.id_swaps``). Runs on the card
unless ``--device cpu`` is given; then step 5 compares the plain
versions with themselves, and says so.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch.core.ivfpq import exact_search, id_swaps, recall_at_k
from repro_torch.serve import DatastoreBuilder

N, DIM, CLUSTERS = 16384, 64, 64


def make_database(seed: int = 0) -> torch.Tensor:
    """16 384 x 64 float32 vectors around 64 centres (on the CPU: the
    same data whatever device the index is built on)."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.randn((CLUSTERS, DIM), generator=g)
    assign = torch.randint(0, CLUSTERS, (N,), generator=g)
    return centers[assign] + 0.1 * torch.randn((N, DIM), generator=g)


def search_recall(ds, vecs: torch.Tensor):
    """Steps 3-4 on a built datastore: the search of 32 queries (the
    first 32 vectors, shifted by 0.02) at nprobe 16, K 32, and R10@32
    against ``exact_search``. Returns (queries, dists, ids, recall)."""
    ccfg = ds.search_config(nprobe=16, k=32)
    queries = vecs[:32] + 0.02
    dists, ids = ds.retriever(ccfg).search(queries)
    _, true_ids = exact_search(vecs, queries, 10)
    return queries, dists, ids, recall_at_k(ids, true_ids)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    # 1) a database with cluster structure
    vecs = make_database().to(dev)

    # 2) IVF-PQ quantizers and 4 memory-node shards (paper partition
    #    scheme 1: every IVF list striped across all shards)
    builder = DatastoreBuilder(dim=DIM, nlist=64, m=16, list_cap=512,
                               num_shards=4, kmeans_iters=10, seed=0,
                               device=str(dev))
    ds = builder.build(vecs, train_vectors=vecs[:8192])
    print(f"index: {ds.index_cfg.nlist} lists, {ds.num_shards} memory "
          f"nodes, {ds.index_cfg.db_bytes_per_vector():.0f} B/vector",
          flush=True)

    # 3) search: the IVF probe, the PQ scan, the merge of truncated
    #    top-k' lists, through the Retriever protocol; 4) recall against
    #    exact brute force: the true top-10 among the 32 returned
    queries, dists, ids, recall = search_recall(ds, vecs)
    kprime = ds.search_config(nprobe=16, k=32).k_prime(ds.num_shards)
    print(f"search: k'={kprime} per node (K=32); R10@32={recall:.3f}",
          flush=True)
    print("nearest ids[0]:", ids[0, :5].tolist(), flush=True)

    # 5) the same search through the plain versions on the CPU
    ccfg = ds.search_config(nprobe=16, k=32)
    d_cpu, i_cpu = ds.to("cpu").retriever(ccfg).search(queries.cpu())
    swaps = id_swaps(dists, ids, d_cpu, i_cpu)    # raises if they disagree
    if dev.type == "cuda":
        print(f"the card's kernels agree with the plain versions: "
              f"dists within 1e-5, ids identical={swaps == 0} "
              f"(near-tie swaps {swaps})", flush=True)
    else:
        print(f"on the CPU: the plain versions against themselves: ids "
              f"identical={swaps == 0}", flush=True)
    return dict(recall=recall, ids=ids.cpu(), dists=dists.cpu(),
                ids_plain=i_cpu, swaps=swaps, device=dev.type)


if __name__ == "__main__":
    main()
