"""The port's sharded train step at 2 x 2 (data x model) on the other
non-dense families against the reference's GSPMD train step
(``torch_train_reference``: reduced models in float32 on the CPU, 3
steps of 4 x 16 tokens resumed from the reference's step-0 checkpoint;
loss, gradient norm and lr within 1e-5 relative, the final parameters
and moments within 1e-3 of each leaf's range):

  * Phi-3.5-MoE with 2 micro-batches (the reference's
    ``build_train_step(..., microbatches=2)``): micro-batch i is the
    global rows [2i, 2i + 2), each data rank computing one of them, and
    the loss is the mean of the two micro-batches' means;
  * RWKV-6 (its time mix split by heads, its channel mix by ``d_ff``
    over "model") and Hymba (4 heads: its Mamba head split by heads and
    channels over "model").
"""
import pytest

from torch_train_reference import check, port, reference

CASES = {"phi3_5_moe_42b_micro2": ("phi3_5_moe_42b", 2),
         "rwkv6_3b": ("rwkv6_3b", 1), "hymba_1_5b": ("hymba_1_5b", 1)}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference_gspmd_step(tmp_path, monkeypatch,
                                                       case):
    arch, micro = CASES[case]
    want = reference(tmp_path, arch, 2, 2, microbatches=micro)
    got = port(tmp_path, arch, 2, 2, microbatches=micro,
               monkeypatch=monkeypatch)
    check(tmp_path, arch, got, want)
