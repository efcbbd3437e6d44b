"""``lm_loss`` and its gradients for the reduced non-dense backbones
(Hymba's attention beside a Mamba head, Phi-3.5-MoE, RWKV-6) against
``jax.value_and_grad(lm_loss)``, in float32: the loss within 1e-6
relative, every gradient leaf within 2e-5 of its range (the checks of
``test_torch_train.py``). And ``remat``: recomputing each layer cycle
in the backward changes no bit of the loss or of any gradient.
"""
import pytest
import torch

from test_torch_train import (check_loss_and_grads, loss_batch, pair,
                              port_loss_and_grads)


@pytest.mark.parametrize("arch", ["hymba_1_5b", "phi3_5_moe_42b",
                                  "rwkv6_3b"])
def test_lm_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch, "float32")


@pytest.mark.parametrize("arch", ["hymba_1_5b", "rwkv6_3b"])
def test_remat_is_bit_equal(arch):
    jcfg, _, tcfg, tp = pair(arch, "float32")
    _, tb = loss_batch(jcfg, tcfg)
    loss_r, grads_r = port_loss_and_grads(tcfg, tp, tb, remat=True)
    loss, grads = port_loss_and_grads(tcfg, tp, tb, remat=False)
    assert torch.equal(loss_r, loss)
    for key in grads:
        assert torch.equal(grads_r[key], grads[key]), key
