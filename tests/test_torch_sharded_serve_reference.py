"""The port's sharded prefill and serve steps against the reference's
GSPMD steps at 2 x 2 (reduced models in float32 on the CPU;
``tests/torch_serve_reference.py`` runs both): Dec-S and EncDec-S at a
batch of 8 (K/V rows over "data", the sequence over "model", the query
split) and Dec-S at a batch of 1 (the sequence over data x model, the
probe split). Logits of every step and the caches gathered back with
``gather_named`` within 1e-5 relative / 1e-5 absolute, search ids exact
and distances within 1e-5 relative.
"""
import pytest

import torch_serve_reference as ref_lib

CASES = [("dec_s", 8, {}), ("encdec_s", 8, {}), ("dec_s", 1, {})]
IDS = [f"{a}_b{B}" for a, B, _ in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref_lib.runs(tmp_path_factory.mktemp("sharded_serve"), CASES)


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_logits_match_the_gspmd_steps(runs, n):
    refs, got = runs
    ref_lib.check_logits(refs[n], got[n])


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_search_matches_the_distributed_search(runs, n):
    refs, got = runs
    ref_lib.check_search(refs[n], got[n])


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_caches_gathered_match(runs, n):
    refs, got = runs
    ref_lib.check_caches(refs[n], got[n])
