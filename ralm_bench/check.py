"""The comparison that decides ``correct``.

After the window has closed, a sample of the requests that finished in
it, drawn from the seed among those that recorded their neighbours, with
the longest among them (``pick``), is judged against the plain
reference. What is compared follows the configuration's retrieval mode:
``compare/<rag.mode>.py`` defines its numbers (``NUMBERS``), reads them
(``readings``) and gives the precision control's outputs on the same
sample (``control_outputs``); the reference model is the configuration's
family module, ``reference/<reference>.py``.

A run is correct when each number is at or below its limit
(``limits/<cell>.json``). A limit of null leaves that number out of the
cell's comparison: one that the control does not fail by a clear margin
there cannot tell the two apart. With ``control`` the control's numbers
are judged against the same limits too (``control_correct``), which
they have to fail.
"""
from __future__ import annotations

import importlib

import numpy as np

from ralm_bench.inputs import sub_seed


def family(cfg: dict):
    """The configuration's reference model module (``reference`` key)."""
    return importlib.import_module(f"ralm_bench.reference.{cfg['reference']}")


def comparison(cfg: dict):
    """The comparison module of the configuration's retrieval mode."""
    return importlib.import_module(f"ralm_bench.compare.{cfg['rag']['mode']}")


def pick(finished, count: int, seed: int) -> list:
    """The longest traced request, then others drawn from the seed."""
    traced = sorted((r for r in finished if r.traced), key=lambda r: r.j)
    if not traced:
        return []
    longest = max(traced, key=lambda r: (r.steps * r.rows, -r.j))
    rest = [r for r in traced if r is not longest]
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    order = rng.permutation(len(rest))[:max(0, count - 1)]
    return [longest] + [rest[i] for i in sorted(order)]


def judge(numbers: dict, limits: dict, names: dict) -> dict:
    """Each of ``names`` (name: what it is) against its limit, but those
    whose limit is null."""
    out, bad = {}, []
    for name, what in names.items():
        value, limit = numbers.get(name), limits[name]
        if limit is None:
            continue
        out[name] = dict(value=value, limit=limit, what=what)
        if value is None or not value <= limit:
            bad.append(name)
    why = "every number within its limit" if not bad else \
        "over the limit or not read: " + ", ".join(bad)
    return dict(correct=not bad, why=why, numbers=out)


def judge_run(cfg: dict, mix: dict, limits: dict, params, index,
              finished, seed: int, control: bool = False) -> dict:
    """The run's verdict; with ``control`` also the control's numbers on
    the same sample (``control_numbers``) and their verdict
    (``control_correct``)."""
    fam, cmp = family(cfg), comparison(cfg)
    sample = pick(finished, mix["check_requests"], seed)
    if not sample:
        return judge({}, limits, cmp.NUMBERS) | {
            "why": "no request that recorded its neighbours finished in "
                   "the window"}
    samples = [cmp.served(r) for r in sample]
    n = mix["check_queries"]
    out = judge(cmp.readings(fam, cfg, params, index, samples, n, seed),
                limits, cmp.NUMBERS)
    if control:
        lower = [cmp.control_outputs(fam, cfg, params, index, s)
                 for s in samples]
        numbers = cmp.readings(fam, cfg, params, index, lower, n, seed)
        out["control_numbers"] = numbers
        out["control_correct"] = judge(numbers, limits,
                                       cmp.NUMBERS)["correct"]
    out["compared_tokens"] = int(sum(s.tokens.size for s in samples))
    return out
