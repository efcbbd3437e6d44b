"""The port's sharded prefill and serve steps for RWKV-6 (no attention:
its ``wkv`` state splits its heads over "model", the shifts ``st`` /
``sc`` their rows over "data") and Phi-3.5-MoE (the FFN routes the global
batch under the reference's capacity) against the reference's GSPMD
steps at 2 x 2 (reduced models in float32 on the CPU;
``tests/torch_serve_reference.py`` runs both). The second MoE case draws
its prompts from 2 token ids, so the routing piles up and the prefill
drops assignments past the capacity of the global batch's 128 tokens (a
rank that routed only its own rows would count another capacity and
drop others). Logits of every step and the caches gathered back with
``gather_named`` within 1e-5 relative / 1e-5 absolute, RWKV-6 within 2e-5
of each tensor's range (its chunked prefill, as in
``tests/test_torch_nondense_archs.py``), search ids exact and distances
within 1e-5 relative.
"""
import pytest
import torch

import torch_serve_ranks
import torch_serve_reference as ref_lib
from repro_torch.launch import dp
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as moe_lib

CASES = [("rwkv6_3b", 8, {}), ("rwkv6_3b", 1, {}), ("phi3_5_moe_42b", 8, {}),
         ("phi3_5_moe_42b", 8, {"prompt_vocab": 2})]
IDS = ["rwkv6_3b_b8", "rwkv6_3b_b1", "phi3_5_moe_42b_b8",
       "phi3_5_moe_42b_b8_drops"]
RANGE_TOL = {"rwkv6_3b": 2e-5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref_lib.runs(tmp_path_factory.mktemp("sharded_nondense"), CASES)


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_nondense_logits_match_the_gspmd_steps(runs, n):
    refs, got = runs
    ref_lib.check_logits(refs[n], got[n], RANGE_TOL.get(CASES[n][0]))


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_nondense_caches_gathered_match(runs, n):
    refs, got = runs
    ref_lib.check_caches(refs[n], got[n], RANGE_TOL.get(CASES[n][0]))


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_nondense_search_matches_the_distributed_search(runs, n):
    refs, got = runs
    ref_lib.check_search(refs[n], got[n])


def test_moe_drops_case_prefill_drops_past_capacity(runs, monkeypatch):
    """The drops case's prefill, run in one process on the same inputs,
    routes more assignments to an expert than the global capacity
    keeps."""
    refs, _ = runs
    arch, B, _ = CASES[3]
    case = ref_lib.port_case(arch, B, refs[3])
    case["steps"] = []
    dropped, plain = [], moe_lib.moe_ffn

    def counting(x, router_w, w_gate, w_up, w_down, top_k, **kw):
        E = router_w.shape[-1]
        C = moe_lib.capacity(x.shape[0], E, top_k)
        _, ids = moe_lib.route_topk(x, router_w, top_k)
        counts = torch.bincount(ids.reshape(-1), minlength=E)
        dropped.append(int((counts - C).clamp(min=0).sum()))
        return plain(x, router_w, w_gate, w_up, w_down, top_k, **kw)

    monkeypatch.setattr(moe_lib, "moe_ffn", counting)
    one = Mesh(("data", "model"), (1, 1), ("cpu",))
    torch_serve_ranks.run_case(dp.Group.single("cpu"), case, mesh=one)
    assert len(dropped) == torch_serve_ranks.spec_of(arch).model.n_layers
    assert sum(dropped) > 0, dropped
