"""The comparison of a kNN-LM cell (``rag.mode`` "knnlm").

Each sampled request (``check.pick``) is run through the plain
reference: the configuration's family module (``reference/<reference>.py``,
float32) over each prompt and its served tokens (teacher forced), which
gives at every served position the reference's logits and its retrieval
query, and the IVF-PQ search and kNN-LM mix (``reference/search.py``).
Five numbers are compared:

- ``mix_gap``: the widest gap, over every served token of the sample,
  by which the token's log-probability under a kNN-LM mix lies below
  that mix's best. The mix takes the reference's logits and the
  neighbours the engine served, at the distances the engine mixed them
  with, so it judges the LM through prefill and through decode over the
  KV pool, the payload gather, the mix and the greedy choice. The
  engine's own distances are used because exp(-d / T) turns a query's
  rounding into gaps of many nats wherever distances are large beside T
  (Phi-3-mini's are ~1e4 at T = 10): where two neighbours nearly tie,
  bfloat16 and float32 split the weight between them differently, and
  the token follows. ``dist_gap`` judges those distances.
- ``mix_gap_mean``: the mean of the same gaps over every served token.
  A widest gap swings from seed to seed with the nearest tie that a
  sample happens to hold; the mean over thousands of tokens is steady,
  and tells a lower precision, which flips many near ties, from sound
  rounding, which flips few.
- ``dist_gap``: the widest relative gap between the engine's distance to
  a served neighbour and the reference's own, over the same tokens and
  neighbours.
- ``order_gap``: the widest relative gap, over the same tokens and over
  the K ranks, between the reference's distance to the engine's k-th
  neighbour and the k-th smallest of the reference's distances to the
  engine's K. Near ties move it by the queries' rounding; a neighbour
  served out of order moves it by the spread of the distances. It judges
  the ordering that ``mix_gap`` takes from the engine.
- ``id_miss``: over ``check_queries`` served positions drawn from the
  seed, the mean share of the engine's K neighbour ids that are not
  among the reference's own K (its IVF probe, lookup tables, ADC over
  the probed lists of the whole index, per-shard top k' and merge). It
  judges the probe and the scan.

``control_outputs`` is the precision control: what the reference
itself, computed a precision lower (float8 products, bfloat16 lookup
tables), serves at the same positions, whose numbers the limits have to
fail.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ralm_bench.inputs import sub_seed
from ralm_bench.reference import search

NUMBERS = {
    "mix_gap": "widest log-prob gap of a served token below the "
               "reference's best",
    "mix_gap_mean": "mean log-prob gap of a served token below the "
                    "reference's best",
    "dist_gap": "widest relative gap between a served neighbour's "
                "distance and the reference's",
    "order_gap": "widest relative excess of a served neighbour's "
                 "distance over the same rank's among the served set",
    "id_miss": "mean share of served neighbour ids not in the "
               "reference's top K",
}


@dataclasses.dataclass
class Served:
    """One request as judged: its prompt [B, T0] (device), the tokens that
    feed the reference [B, steps], and the outputs judged: the tokens
    [B, steps], the neighbour ids and their distances [steps, B, K]."""
    prompt: torch.Tensor
    inputs: np.ndarray
    tokens: np.ndarray
    ids: np.ndarray
    dists: np.ndarray


def served(req) -> Served:
    """A finished traced request (``traffic.Request``) as judged."""
    toks = np.stack(req.tokens, axis=1).astype(np.int64)       # [B, steps]
    by_step = {step: (d, i) for step, d, i in req.neighbours}
    steps = range(req.steps)
    dists = torch.stack([by_step[s][0] for s in steps]).cpu().numpy()
    ids = torch.stack([by_step[s][1] for s in steps]).cpu().numpy()
    return Served(req.prompt, toks, toks, ids, dists)


def reference_states(family, params, model: dict, s: Served,
                     quant: Optional[str] = None):
    """(queries [B, steps, d], logits [B, steps, V]) at the served
    positions, teacher forced on the prompt and the served tokens."""
    t0 = s.prompt.shape[1]
    feed = torch.as_tensor(s.inputs[:, :-1], device=s.prompt.device)
    seq = torch.cat([s.prompt.long(), feed], 1)
    h = family.hidden_states(params, model, seq, quant)[:, t0 - 1:]
    return h, family.logits(params, model, h, quant)


def readings(family, cfg: dict, params, index, samples: List[Served],
             n_queries: int, seed: int, block: int = 2048) -> dict:
    """The compared numbers of ``samples`` against the reference."""
    model, rag, icfg = cfg["model"], cfg["rag"], cfg["index"]
    rng = np.random.default_rng(sub_seed(seed, "queries"))
    spots = [(i, b, t) for i, s in enumerate(samples)
             for b in range(s.tokens.shape[0])
             for t in range(s.tokens.shape[1])]
    chosen = sorted(rng.choice(len(spots), min(n_queries, len(spots)),
                               replace=False))
    by_sample = {}
    for k in chosen:
        i, b, t = spots[k]
        by_sample.setdefault(i, []).append((b, t))
    widest, order, dgap, misses = 0.0, 0.0, 0.0, []
    gap_sum, gap_n = 0.0, 0
    for i, s in enumerate(samples):
        h, lg = reference_states(family, params, model, s)
        B, steps, d = h.shape
        dev = h.device
        q = h.reshape(-1, d)
        ids = torch.as_tensor(s.ids, device=dev).transpose(0, 1) \
            .reshape(B * steps, -1)
        served_d = torch.as_tensor(s.dists, device=dev).transpose(0, 1) \
            .reshape(B * steps, -1)
        tok = torch.as_tensor(s.tokens, device=dev).reshape(-1)
        flat_lg = lg.reshape(B * steps, -1)
        for a in range(0, q.shape[0], block):
            z = slice(a, a + block)
            mixed = search.knn_mix(flat_lg[z], served_d[z],
                                   search.payload(index, ids[z]),
                                   rag["lam"], rag["temperature"])
            gaps = search.gap(mixed, tok[z])
            widest = max(widest, float(gaps.max()))
            gap_sum += float(gaps.double().sum())
            gap_n += gaps.numel()
            dist = search.distances_of(index, q[z], ids[z])
            fin = torch.isfinite(dist)
            scale = dist.abs().clamp(min=1e-30)
            rel = (served_d[z] - dist).abs() / scale
            dgap = max(dgap, float(torch.where(fin, rel, 0.0).max()))
            ranked = dist.sort(-1).values
            rel = (dist - ranked).abs() / ranked.abs().clamp(min=1e-30)
            order = max(order, float(torch.where(fin, rel, 0.0).max()))
        spots_i = by_sample.get(i, [])
        if spots_i:
            rows = torch.tensor([b * steps + t for b, t in spots_i],
                                device=dev)
            _, ref_ids = search.search(index, q[rows], icfg["nprobe"],
                                       rag["k"], icfg["eps"])
            got = ids[rows]
            hit = (got[:, :, None] == ref_ids[:, None, :]).any(-1)
            misses.extend((1.0 - hit.float().mean(-1)).tolist())
        del h, lg, q, flat_lg
    return {"mix_gap": widest, "mix_gap_mean": gap_sum / max(1, gap_n),
            "dist_gap": dgap, "order_gap": order,
            "id_miss": float(np.mean(misses)) if misses else None}


def control_outputs(family, cfg: dict, params, index, s: Served,
                    block: int = 256) -> Served:
    """What the reference computed a precision lower serves at each
    position of ``s``'s prompt and tokens: its argmax token and its ids."""
    model, rag, icfg = cfg["model"], cfg["rag"], cfg["index"]
    h, lg = reference_states(family, params, model, s, quant="fp8")
    B, steps, d = h.shape
    q, flat_lg = h.reshape(-1, d), lg.reshape(B * steps, -1)
    toks, ids, dists = [], [], []
    for a in range(0, q.shape[0], block):
        z = slice(a, a + block)
        dist, got = search.search(index, q[z], icfg["nprobe"], rag["k"],
                                  icfg["eps"], lut_dtype=torch.bfloat16)
        mixed = search.knn_mix(flat_lg[z], dist, search.payload(index, got),
                               rag["lam"], rag["temperature"])
        toks.append(mixed.argmax(-1))
        ids.append(got)
        dists.append(dist)

    def by_step(parts):
        return torch.cat(parts).reshape(B, steps, -1).transpose(0, 1) \
            .cpu().numpy()

    toks = torch.cat(toks).reshape(B, steps).cpu().numpy()
    return Served(s.prompt, s.inputs, toks, by_step(ids), by_step(dists))
