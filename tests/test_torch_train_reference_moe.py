"""The port's train steps on reduced Phi-3.5-MoE (4 experts top-2, float32
on the CPU) against the reference's GSPMD train step
(``torch_train_reference``: 3 steps of 4 x 16 tokens resumed from the
reference's step-0 checkpoint; loss, gradient norm and lr within 1e-5
relative, the final parameters and moments within 1e-3 of each leaf's
range). The reference's step is one program over the global batch, so
its MoE routes every token under one capacity; the port's ranks each
hold their rows, and route the rows gathered over "data":

  * ``python -m repro_torch.launch.train`` at ``--data 2 --model 2`` (the
    sharded step: the experts split over "data", each expert's ``f`` over
    "model") and at ``--data 2 --model 1`` (the data-parallel step, every
    rank holding every expert);
  * at 2 x 2 on batches whose ids are taken mod 2
    (``torch_sharding_ranks``' ``--few-ids``): the routing piles up, and
    the reference's routing of the step-0 batch drops assignments past
    the capacity of its 64 tokens.
"""
import json

import pytest

from test_torch_sharding import args_for
from torch_train_reference import STEPS, check, launcher, port, reference

ARCH = "phi3_5_moe_42b"


@pytest.mark.parametrize("data,model", [(2, 2), (2, 1)])
def test_moe_launcher_matches_the_reference_gspmd_step(tmp_path, data,
                                                       model):
    want = reference(tmp_path, ARCH, data, model)
    out, got = launcher(*args_for(ARCH, tmp_path / "ckpt", STEPS),
                        "--data", str(data), "--model", str(model))
    assert f"{data * model} ranks on cpu" in out
    check(tmp_path, ARCH, [got[s] for s in range(STEPS)], want)


def test_moe_routing_that_drops_matches_the_reference(tmp_path, monkeypatch):
    want = reference(tmp_path, ARCH, 2, 2, few_ids=2)
    drops = json.loads((tmp_path / "drops.json").read_text())
    assert len(drops) == 4 and sum(drops) > 0, drops
    got = port(tmp_path, ARCH, 2, 2, few_ids=2, monkeypatch=monkeypatch)
    check(tmp_path, ARCH, got, want)
