"""Split compute in the sharded steps' layers, on gloo ranks on the CPU
(reduced models in float32; ``torch_layer_ranks`` runs each layer on a
rank's shards and rows and holds it against the whole layer in one
process):

  * the MoE FFN with expert parallelism, at 2 x 1, 4 x 1 and 2 x 2 (data
    x model): each rank keeps its E / D experts (and, at 2 x 2, half of
    each expert's ``f``), routes the global batch's tokens, near one point
    so that the routing drops assignments past the capacity; the output
    within 1e-6 of its range, the gradients of the input and of every
    leaf's shard within 1e-5 of theirs;
  * Hymba's Mamba head and an RWKV-6 block split over "model" at 1 x 2:
    each rank keeps its heads and channels of every leaf that splits
    (Mamba's ``w_in``: rank 0 holds the x columns, rank 1 the z columns;
    each computes with the x and z of its own channels), output,
    gradients and (Mamba, resumed from a seeded state) the rank's heads
    of the returned state within 1e-5 of their range;
  * in one process: routing each rank's rows alone parts from routing the
    global batch, and ``transformer._split_leaves`` keeps a group split
    only where its heads divide the model axis (full Hymba's 25 heads
    over 2 ranks: its attention and Mamba leaves gathered) and the
    experts split over "data" where E divides it.
"""
import json
import os
import pathlib

import pytest
import torch

import torch_layer_ranks as ranks_lib
from repro_torch.configs import get_arch
from repro_torch.launch import dp
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import ctx as ctx_lib
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import keyed_specs, param_specs, sanitize

TESTS = pathlib.Path(__file__).resolve().parent
CASES = [("moe", 2, 1), ("moe", 4, 1), ("moe", 2, 2), ("mamba", 1, 2),
         ("rwkv6", 1, 2)]


def launch(tmp_path, monkeypatch, case, data, model):
    out = tmp_path / f"{case}{data}x{model}"
    out.mkdir()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "")
                        .split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dp.launch(data * model, "torch_layer_ranks:run", [str(out), case],
              device="cpu", timeout_s=300, model=model)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(data * model)]


@pytest.mark.parametrize("case,data,model", CASES,
                         ids=[f"{c}_{d}x{m}" for c, d, m in CASES])
def test_split_layer_matches_the_whole_layer(tmp_path, monkeypatch, case,
                                             data, model):
    cfg = ranks_lib.cfg_of(case)
    for r in launch(tmp_path, monkeypatch, case, data, model):
        bad = {}
        for name, (err, scale) in r["errors"].items():
            tol = 1e-6 if name.endswith("/out") and case == "moe" else 1e-5
            if not err <= tol * max(scale, 1e-30):
                bad[name] = (err, scale)
        assert not bad, bad
        for shape in r["shapes"].values():
            if case == "moe":       # E / D experts, f / M columns each
                assert shape["wg"] == [cfg.n_experts // data, cfg.d_model,
                                       cfg.d_ff // model]
                assert shape["wd"][:2] == [cfg.n_experts // data,
                                           cfg.d_ff // model]
            elif case == "mamba":   # the rank's heads and channels
                d_in = cfg.n_heads * cfg.d_head // model
                assert shape["mamba/w_in"] == [cfg.d_model, 2 * d_in]
                assert shape["mamba/conv_w"][-1] == d_in
                assert shape["mamba/w_out"][0] == d_in
            else:
                D = cfg.n_heads * cfg.d_head // model
                assert shape["w_r"] == [cfg.d_model, D]
                assert shape["w_o"] == [D, cfg.d_model]
                assert shape["ln_x"] == [D]
                assert shape["w_ck"][-1] == cfg.d_ff // model
                assert shape["w_cr"][-1] == cfg.d_model // model
        if case == "moe":
            assert r["drops"] > 0


def test_moe_rows_routed_alone_part_from_the_global_batch():
    cfg = ranks_lib.cfg_of("moe")
    stacked = ranks_lib.stacked_leaves("moe", cfg)
    p = tf._layer_params(cfg, ranks_lib.PREFIX, stacked, 0)
    x = ranks_lib.moe_input(cfg, 8, 16)
    assert ranks_lib.moe_drops(cfg, stacked, x) > 0
    whole = tf._ffn(cfg, p, x)
    for D in (2, 4):
        alone = torch.cat([tf._ffn(cfg, p, rows) for rows in x.chunk(D)])
        assert not torch.allclose(alone, whole, atol=1e-4)


class _Axis:
    def __init__(self, size):
        self.size, self.rank = size, 0


class _MeshGroup:
    """The sizes ``models.parallel`` reads of a mesh group, without
    collectives."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.size = data * model

    def axis(self, name):
        return _Axis(self.shape[name])


def split_leaves(cfg, data, model):
    mesh = make_mesh_for(["cpu"] * (data * model), data=data, model=model)
    struct = tf.init_params(None, cfg)
    specs = keyed_specs(sanitize(param_specs(cfg, mesh, struct), struct,
                                 mesh))
    with ctx_lib.activation_sharding(("data",), "model",
                                     group=_MeshGroup(data, model),
                                     specs=specs):
        return tf._split_leaves(cfg, "classes/global",
                                struct["classes"]["global"])


MAMBA = {"mamba/w_in", "mamba/conv_w", "mamba/w_bcdt", "mamba/w_out"}
ATTN = {"wq", "wk", "wv", "wo"}
TIME_MIX = {"w_r", "w_k", "w_v", "w_g", "w0", "w_lora_b", "ln_x", "w_o"}


def test_split_leaves_follow_the_heads_and_experts():
    hymba = get_arch("hymba_1_5b")
    model, data = split_leaves(hymba.model, 1, 2)      # 25 heads over 2
    assert not model & (MAMBA | ATTN) and {"wg", "wu", "wd"} <= model
    assert not data
    model, _ = split_leaves(hymba.reduced, 1, 2)       # 4 heads over 2
    assert MAMBA | ATTN <= model
    rwkv = get_arch("rwkv6_3b").model                  # 40 heads
    for M in (2, 4):
        model, _ = split_leaves(rwkv, 1, M)
        assert TIME_MIX | {"w_ck", "w_cv", "w_cr"} <= model
    moe = get_arch("phi3_5_moe_42b").model             # 16 experts
    model, data = split_leaves(moe, 2, 2)
    assert data == {"wg", "wu", "wd"} and ATTN | data <= model
    _, data = split_leaves(moe, 3, 1)                  # 16 over 3: whole
    assert not data
    assert split_leaves(moe, 1, 1) == (set(), set())
