"""The port's sharded prefill and serve steps for Hymba (attention and
Mamba in one block) and Gemma-3, whose local layers keep ring caches,
against the reference's GSPMD steps at 2 x 2 (reduced models in float32
on the CPU; ``tests/torch_serve_reference.py`` runs both). The rings
(8 slots, a 16-token prompt: they wrap at prefill) split over "model" at
a batch of 8 and over data x model at a batch of 1, so a rank holds 4 or
2 slots; Hymba's Mamba state splits its heads (``ssm``) and channels
(``conv``) over "model". Logits of every step and the caches gathered
back with ``gather_named`` within 1e-5 relative / 1e-5 absolute, search
ids exact and distances within 1e-5 relative.
"""
import pytest

import torch_serve_reference as ref_lib

CASES = [("hymba_1_5b", 8, {}), ("hymba_1_5b", 1, {}), ("gemma3_4b", 8, {}),
         ("gemma3_4b", 1, {})]
IDS = [f"{a}_b{B}" for a, B, _ in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref_lib.runs(tmp_path_factory.mktemp("sharded_rings"), CASES)


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_ring_logits_match_the_gspmd_steps(runs, n):
    refs, got = runs
    ref_lib.check_logits(refs[n], got[n])


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_ring_caches_gathered_match(runs, n):
    refs, got = runs
    ref_lib.check_caches(refs[n], got[n])


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_ring_search_matches_the_distributed_search(runs, n):
    refs, got = runs
    ref_lib.check_search(refs[n], got[n])
