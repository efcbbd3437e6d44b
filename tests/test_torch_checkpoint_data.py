"""The port's checkpoints and data pipeline against the JAX package's.

  * Data: ``SyntheticTokens`` and ``MemmapTokens`` batches equal the
    reference's bit for bit for several (seed, step, host_id,
    num_hosts); host shards are disjoint and cover the global batch; the
    memmap windows are the corpus shifted by one; ``Prefetcher`` yields
    steps in order.
  * Checkpoints: a tree with float32, bfloat16 and int32 leaves, nested
    dicts, a tuple and NamedTuples (``OptState``, ``MambaParams``) saved
    by the port restores in the JAX package and the other way round, bit
    for bit and in each leaf's dtype, with the same manifest (keys, file
    names, shapes, dtype names); the newest complete step wins over a
    crashed write; a shape mismatch raises; the async checkpointer keeps
    the newest ``keep`` steps.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.data import pipeline as jdata
from repro.models.ssm import MambaParams as JaxMamba
from repro.optim.adamw import OptState as JaxOptState
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.data.pipeline import (DataConfig, MemmapTokens, Prefetcher,
                                       SyntheticTokens)
from repro_torch.models.ssm import MambaParams
from repro_torch.optim.adamw import OptState


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1234, 7])
def test_synthetic_batches_equal_reference(seed):
    cfg = dict(seq_len=12, global_batch=8, vocab_size=1000, seed=seed)
    mine = SyntheticTokens(DataConfig(**cfg))
    ref = jdata.SyntheticTokens(jdata.DataConfig(**cfg))
    for step in (0, 1, 17, 1000):
        for hosts in (1, 2, 4, 8):
            for h in range(hosts):
                a, b = mine.host_batch(step, h, hosts), \
                    ref.host_batch(step, h, hosts)
                assert sorted(a) == sorted(b) == ["labels", "tokens"]
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_memmap_batches_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, 500, size=20000).astype(np.int32)
    path = tmp_path / "corpus.bin"
    MemmapTokens.write_corpus(path, corpus)
    cfg = dict(seq_len=16, global_batch=8, vocab_size=500, seed=3)
    mine = MemmapTokens(path, DataConfig(**cfg))
    ref = jdata.MemmapTokens(path, jdata.DataConfig(**cfg))
    assert mine.n_windows == ref.n_windows
    for step in (0, 5, 155, 156, 400):      # 156 x 8 rows pass an epoch
        for hosts in (1, 2, 4):
            for h in range(hosts):
                a, b = mine.host_batch(step, h, hosts), \
                    ref.host_batch(step, h, hosts)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    b = mine.batch(0)
    assert b["tokens"].shape == (8, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="too small"):
        MemmapTokens(path, DataConfig(seq_len=4096, global_batch=8,
                                      vocab_size=500))


def test_host_shards_disjoint_and_covering():
    src = SyntheticTokens(DataConfig(seq_len=8, global_batch=8,
                                     vocab_size=50))
    full = src.batch(3)
    for hosts in (2, 4, 8):
        for k in full:
            parts = [src.host_batch(3, h, hosts)[k] for h in range(hosts)]
            assert all(len(p) == 8 // hosts for p in parts)
            np.testing.assert_array_equal(np.concatenate(parts), full[k])
    np.testing.assert_array_equal(src.batch(17)["tokens"],
                                  src.batch(17)["tokens"])
    assert not np.array_equal(src.batch(18)["tokens"],
                              src.batch(17)["tokens"])


def test_prefetcher_order():
    src = SyntheticTokens(DataConfig(seq_len=4, global_batch=4,
                                     vocab_size=10))
    pf = Prefetcher(src, start_step=10, depth=2, host_id=1, num_hosts=2)
    try:
        for want in (10, 11, 12, 13):
            s, batch = next(pf)
            assert s == want
            np.testing.assert_array_equal(
                batch["tokens"], src.host_batch(want, 1, 2)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def numpy_tree(seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)
    params = {"embed": f(6, 4), "final_norm": f(4),
              "classes": {"global": {"wq": f(2, 4, 4),
                                     "mamba": dict(w_in=f(2, 4, 6),
                                                   a_log=f(2, 3),
                                                   conv_w=f(2, 2, 3),
                                                   w_bcdt=f(2, 3, 5),
                                                   dt_bias=f(2, 3),
                                                   d_skip=f(2, 3),
                                                   w_out=f(2, 3, 4))}}}
    return params, f


def port_tree(seed=0):
    params, f = numpy_tree(seed)

    def conv(x, bf16=True):
        if isinstance(x, dict):
            if "w_in" in x:
                return MambaParams(**{k: conv(v, k not in ("a_log",))
                                      for k, v in x.items()})
            return {k: conv(v) for k, v in x.items()}
        t = torch.tensor(x)
        return t.bfloat16() if bf16 else t
    p = conv(params)
    m = tree_lib.map(lambda t: torch.full_like(t, 0.25), p)
    v = tree_lib.map(lambda t: t.float() ** 2, p)
    return (p, OptState(torch.tensor(7, dtype=torch.int32), m, v),
            [torch.tensor(f(3))])


def to_jax(tree):
    """The same tree in the JAX package's types, leaf for leaf."""
    def conv(x):
        if isinstance(x, MambaParams):
            return JaxMamba(**{k: conv(getattr(x, k)) for k in x._fields})
        if isinstance(x, OptState):
            return JaxOptState(conv(x.step), conv(x.m), conv(x.v))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(c) for c in x)
        a = jnp.asarray(x.float().numpy() if x.is_floating_point()
                        else x.numpy())
        return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a
    return conv(tree)


def assert_bit_equal(port, ref):
    mine, theirs = tree_lib.keyed(port), {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        theirs["/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path)] = leaf
    assert sorted(mine) == sorted(theirs)
    for key, t in mine.items():
        r = np.asarray(theirs[key])
        assert str(t.dtype).replace("torch.", "") == str(r.dtype), key
        assert tuple(t.shape) == r.shape, key
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), r)


def test_port_save_restores_in_reference(tmp_path):
    tree = port_tree()
    ck.save(tmp_path / "a", 3, tree)
    jck.save(tmp_path / "b", 3, to_jax(tree))
    ma = json.loads((tmp_path / "a/step_00000003/manifest.json").read_text())
    mb = json.loads((tmp_path / "b/step_00000003/manifest.json").read_text())
    assert ma == mb
    assert "0/classes/global/mamba/w_in" in ma["leaves"]
    assert ma["leaves"]["1/m/embed"]["dtype"] == "bfloat16"
    got, step = jck.restore(tmp_path / "a", to_jax(port_tree(1)))
    assert step == 3
    assert_bit_equal(tree, got)


def test_reference_save_restores_in_port(tmp_path):
    tree = port_tree()
    jck.save(tmp_path, 5, to_jax(tree))
    got, step = ck.restore(tmp_path, port_tree(2))
    assert step == 5
    assert isinstance(got[1], OptState)
    assert isinstance(got[0]["classes"]["global"]["mamba"], MambaParams)
    assert_bit_equal(got, to_jax(tree))
    assert_bit_equal(tree, to_jax(got))


def test_latest_complete_wins(tmp_path):
    tree = port_tree()
    ck.save(tmp_path, 1, tree)
    ck.save(tmp_path, 5, tree)
    (tmp_path / ".tmp_step_00000009").mkdir()        # a crashed write
    (tmp_path / "step_00000011").mkdir()             # no manifest yet
    assert ck.latest_step(tmp_path) == 5
    _, step = ck.restore(tmp_path, tree)
    assert step == 5
    assert ck.latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "absent", tree)


def test_shape_mismatch_rejected(tmp_path):
    tree = port_tree()
    ck.save(tmp_path, 1, tree)
    p, opt, extra = port_tree()
    bad = (dict(p, embed=torch.zeros(3, 3)), opt, extra)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(tmp_path, bad)


def test_async_checkpointer_gc(tmp_path):
    tree = port_tree()
    saver = ck.AsyncCheckpointer(tmp_path, keep=2)
    saved = []
    for s in (1, 2, 3, 4):
        saver.save(s, tree)
        saved.append(tree[0]["embed"].clone())
        tree[0]["embed"].add_(1)      # after save returns: not in step s
    saver.wait()
    steps = sorted(d.name for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    got, _ = ck.restore(tmp_path, tree, step=4)
    assert torch.equal(got[0]["embed"], saved[3])
