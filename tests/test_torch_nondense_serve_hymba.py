"""Hymba-1.5B (attention and a Mamba head in every block; global layers
and 8-slot ring layers at the reduced size) served by the port's engine
against the JAX engine on the CPU: the recipe and checks of
``tests/test_torch_nondense_serve.py``. The prompts (12 and 9 tokens)
run the rings round in prefill and again in decode, while the Mamba
state rides in the pool's rows beside K/V. Speculation is turned off with a
warning: the state cannot be rewound.
"""
import pytest

from test_torch_assigned_serve import make_backbone
from test_torch_nondense_serve import (MODES, check_mode, jax_tokens,
                                       port_engine)


@pytest.fixture(scope="module")
def backbone():
    t = make_backbone("hymba_1_5b")
    return t, jax_tokens(t)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_match_jax_engine(backbone, mode):
    t, want = backbone
    teng = check_mode(t, want, mode)
    caches = teng.pool.caches["classes"]
    assert caches["local"]["k"].shape[2] == t["cfg"].window < 12
    assert {"k", "v", "ssm", "conv"} <= set(caches["global"])


def test_speculation_refused_for_recurrent_state(backbone):
    t, _ = backbone
    with pytest.warns(RuntimeWarning, match="recurrent-state"):
        eng = port_engine(t, "wave_async", speculate_k=1)
    assert eng.speculate_k == 0
