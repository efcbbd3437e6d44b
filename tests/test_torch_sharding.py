"""Parameter sharding in the port (``models.sharding.put_named`` /
``gather_named``, the sharded ``build_train_step``), Dec-S on gloo ranks
on the CPU, against the port's one-rank step (float32 parameters and
moments, 3 steps of 4 x 16 tokens; the ranks run
``torch_sharding_ranks``):

  * at 1 x 2 and 2 x 2 (data x model): every step's loss within 1e-5
    relative of one rank's, the gradient norm and lr too, every rank's
    loss the same, and the parameters and moments after the last step
    within 1e-4 of each leaf's range;
  * every rank's local leaves have ``shard_shape`` of their sanitised
    ``param_specs`` over the mesh, and its resident parameter and
    moment bytes are the dry run's per-device count
    (``dryrun.state_bytes_per_dev``);
  * the run's checkpoint holds whole leaves, bit-equal to
    ``gather_named`` of the final shards;
  * ``constrain`` is the identity outside a context, checks the shard
    inside one and raises on a wrong layout; ``put_named`` splits a
    tree into shards whose concatenation is the tree.
"""
import json
import os
import pathlib

import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.launch import dp, dryrun, train
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import ctx as ctx_lib
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import (P, keyed_specs, param_specs,
                                         put_named, sanitize, shard_shape)
from repro_torch.optim import adamw

TESTS = pathlib.Path(__file__).resolve().parent
STEPS = 3


def args_for(arch, ckpt_dir, steps=STEPS, extra=()):
    return ["--arch", arch, "--reduced", "--device", "cpu", "--dtype",
            "float32", "--state-dtype", "float32", "--steps", str(steps),
            "--seq-len", "16", "--batch", "4", "--ckpt-every", str(steps),
            "--ckpt-dir", str(ckpt_dir), *extra]


def run_mesh(tmp_path, monkeypatch, arch, data, model, extra=(),
             steps=STEPS, name=None):
    """The launcher's run on data x model ranks; returns (per-rank
    records, out dir)."""
    out = tmp_path / (name or f"mesh{data}x{model}")
    out.mkdir()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "")
                        .split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dp.launch(data * model, "torch_sharding_ranks:run",
              [str(out)] + args_for(arch, out / "ckpt", steps, extra),
              device="cpu", timeout_s=300, model=model)
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(data * model)]
    return ranks, out


def run_one(tmp_path, arch, extra=(), steps=STEPS):
    """The same run on one rank, in this process: (metrics, ckpt dir)."""
    import torch_sharding_ranks
    ck = tmp_path / "one"
    ctl, _, _ = torch_sharding_ranks.train(
        dp.Group.single("cpu"), args_for(arch, ck, steps, extra))
    return ctl.metrics_log, ck


def cfg_of(arch):
    cfg, ocfg, _ = train.setup(train.parser().parse_args(
        args_for(arch, "unused")))
    return cfg, ocfg


def restore(ck_dir, cfg, ocfg, step=None):
    like = tf.init_params(None, cfg)
    like = (like, adamw.init_opt_state(like, ocfg))
    return ckpt_lib.restore(ck_dir, like, step=step, device="cpu")[0]


#: leaves whose exact gradient is 0: a key bias shifts every score of a
#: query's row alike, which the softmax ignores. Both runs' gradients are
#: round-off, which AdamW's normalised step turns into moves of up to lr
#: a step, so these are held to ``STEPS * lr`` (lr is 3e-4).
ZERO_GRADIENT = ("0/classes/global/bk",)


def close_runs(ranks, one, tree, one_tree, tol=1e-4):
    """Sharded metrics and final trees against one rank's."""
    for r in ranks:
        assert [m["step"] for m in r["metrics"]] == list(range(len(one)))
        for got, ref in zip(r["metrics"], ranks[0]["metrics"]):
            assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    for got, ref in zip(ranks[0]["metrics"], one):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key]), key
    mine, want = tree_lib.keyed(tree), tree_lib.keyed(one_tree)
    assert sorted(mine) == sorted(want)
    bad = {}
    for key, leaf in mine.items():
        ref = want[key].float()
        err = (leaf.float() - ref).abs().max().item()
        bound = STEPS * 3e-4 if key in ZERO_GRADIENT else \
            tol * max(ref.abs().max().item(), 1e-30)
        if not err <= bound:
            bad[key] = (err, ref.abs().max().item())
    assert not bad, bad


def check_layout(ranks, cfg, ocfg, data, model):
    """Every rank's local shapes and resident bytes."""
    mesh = make_mesh_for(["cpu"] * (data * model), data=data, model=model)
    struct = tf.init_params(None, cfg)
    keyed = keyed_specs(sanitize(param_specs(cfg, mesh, struct), struct,
                                 mesh))
    want = {"1/step": []}
    for key, t in tree_lib.keyed(struct).items():
        shape = list(shard_shape(t.shape, keyed[key], mesh))
        want[f"0/{key}"] = want[f"1/m/{key}"] = want[f"1/v/{key}"] = shape
    p_bytes, o_bytes = dryrun.state_bytes_per_dev(cfg, mesh, ocfg)
    for r in ranks:
        assert r["shapes"] == want
        assert (r["param_bytes"], r["moment_bytes"]) == (p_bytes, o_bytes)
    whole = sum(t.numel() * t.element_size()
                for t in tree_lib.leaves(struct))
    return p_bytes, whole


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_dec_s_sharded_follows_one_rank(tmp_path, monkeypatch, data, model):
    ranks, out = run_mesh(tmp_path, monkeypatch, "dec_s", data, model)
    one, one_ck = run_one(tmp_path, "dec_s")
    cfg, ocfg = cfg_of("dec_s")
    tree = restore(out / "ckpt", cfg, ocfg, STEPS)
    close_runs(ranks, one, tree, restore(one_ck, cfg, ocfg, STEPS))
    shard, whole = check_layout(ranks, cfg, ocfg, data, model)
    assert shard < whole
    # the checkpoint: whole leaves, bit-equal to the gathered shards
    gathered = ckpt_lib.restore(out / "gathered", tree, step=STEPS,
                                device="cpu")[0]
    for key, leaf in tree_lib.keyed(tree).items():
        assert torch.equal(leaf, tree_lib.keyed(gathered)[key]), key
    for r in ranks:
        m = r["metrics"][0]
        assert m["model_mb"] > 0 and m["model_ms"] > 0
        assert (m["data_mb"] > 0) == (data > 1)


class FakeGroup:
    """The coordinates ``put_named`` reads, without collectives."""

    def __init__(self, data, model, rank):
        self.shape = {"data": data, "model": model}
        self.coords = dict(zip(("data", "model"), divmod(rank, model)))
        self.device = torch.device("cpu")


def test_put_named_shards_concatenate_to_the_tree():
    mesh = make_mesh_for(["cpu"] * 4, data=2, model=2)
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    tree = {"a": x, "b": (x[0], x[:, 0])}
    specs = {"a": P("model", None, "data"), "b": (P(), P(("data", "model")))}
    shards = [put_named(tree, specs, mesh, FakeGroup(2, 2, r))
              for r in range(4)]
    a = torch.cat([torch.cat([shards[d * 2 + m]["a"] for d in range(2)], 2)
                   for m in range(2)], 0)
    assert torch.equal(a, x)
    for s in shards:
        assert torch.equal(s["b"][0], x[0])
    assert torch.equal(torch.cat([s["b"][1] for s in shards]), x[:, 0])
    assert shards[0]["a"].shape == shard_shape(x.shape, specs["a"], mesh)
    with pytest.raises(ValueError):
        put_named(tree, specs, mesh, FakeGroup(1, 4, 0))
    with pytest.raises(ValueError):
        put_named({"a": x[:3]}, {"a": P("model")}, mesh, FakeGroup(2, 2, 0))


def test_constrain_checks_the_layout():
    x = torch.zeros(2, 5, 3, 16)
    assert ctx_lib.constrain(x, "dp", None, "model", None) is x
    assert ctx_lib.kv_tags() is None
    group = FakeGroup(2, 4, 0)
    group.size = 8
    with ctx_lib.activation_sharding(("data",), "model", group=group,
                                     batch=4):
        assert ctx_lib.kv_tags() == ("dp", "model")
        assert ctx_lib.constrain(x, "dp", None, "model", None,
                                 full=(None, None, 12, 16)) is x
        with pytest.raises(ValueError):        # 3 heads are not 12 / 4
            ctx_lib.constrain(x, "dp", None, "model", None,
                              full=(None, None, 8, 16))
        with pytest.raises(ValueError):        # 2 rows are 4 / 2 ...
            ctx_lib.constrain(x, None, None, None, None,
                              full=(4, None, None, None))
        with pytest.raises(ValueError):        # ... and a tag per dim
            ctx_lib.constrain(x, "dp", None)
        with pytest.raises(ValueError):        # 4 rows do not split 8 ways
            ctx_lib.constrain(x, ("dp", "model"), None, None, None,
                              full=(4, None, None, None))
    with ctx_lib.activation_sharding(("data",), kv_batch=None,
                                     kv_seq=("dp", "model"), batch=2):
        assert ctx_lib.kv_tags() == (None, ("dp", "model"))
        assert ctx_lib.constrain(x, "dp", None, "model", None,
                                 full=(2, 5, 3, 16)) is x
    assert ctx_lib.current() is None
