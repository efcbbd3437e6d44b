"""Gemma-3-4B (5:1 local:global, 8-slot ring caches on its local layers
at the reduced size) and Qwen2-VL-72B (M-RoPE, QKV bias) served by the
port's engine against the JAX engine on the CPU: the recipe and checks
of ``test_torch_assigned_serve.py``, whose prompts run Gemma-3's rings
round in prefill and again in decode; and the datastore's keys from the
port's ``corpus_keys`` against the reference's.
"""
import pytest

from test_torch_assigned_serve import MODES, check_greedy, make_backbone


@pytest.fixture(scope="module", params=("gemma3_4b", "qwen2_vl_72b"))
def backbone(request):
    return make_backbone(request.param)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_match_jax_engine(backbone, mode):
    check_greedy(backbone, mode)


def test_corpus_keys_match_reference(backbone):
    """The datastore's keys: the port's ``DatastoreBuilder.corpus_keys``
    (the hidden state at every prefix; M-RoPE from [B, T] positions,
    Gemma-3's local windows over 32-token documents) against the
    reference's, within 2^-6 of their range (bf16), next tokens equal."""
    import numpy as np
    import torch

    from repro.serve import DatastoreBuilder as JaxBuilder
    from repro_torch.serve import DatastoreBuilder

    t = backbone
    jkeys, jnxt = JaxBuilder.corpus_keys(t["params"], t["cfg"], t["corpus"])
    tkeys, tnxt = DatastoreBuilder.corpus_keys(t["tparams"], t["tcfg"],
                                               t["corpus"], batch=16)
    assert tkeys.dtype == torch.float32 and tkeys.shape == jkeys.shape
    np.testing.assert_array_equal(tnxt.numpy(), jnxt)
    assert np.abs(tkeys.numpy() - jkeys).max() <= \
        2 ** -6 * np.abs(jkeys).max()
