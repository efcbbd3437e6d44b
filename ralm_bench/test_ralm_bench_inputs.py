"""The seeded generators: one seed gives the same prompts, lengths, list
lengths, codes and payload; two seeds differ; every seed offers the same
multiset of lengths."""
import json
import pathlib

import numpy as np
import pytest
import torch

from ralm_bench import inputs, traffic
from ralm_bench.traffic import closed_loop

HERE = pathlib.Path(__file__).resolve().parent
MIX = json.loads((HERE / "traffic" / "batch_64x16.json").read_text())
ICFG = dict(num_vectors=20_000, nlist=32, m=8, nbits=8, residual=False,
            num_shards=2, list_spread=0.2, centroid_noise=0.25)


def requests(seed, n=12):
    loop = closed_loop.Traffic(MIX, seed, 50_000, "cpu")
    return [loop.next(j % MIX["clients"]) for j in range(n)]


def test_traffic_same_seed_same_requests():
    a, b = requests(2 ** 31 + 17), requests(2 ** 31 + 17)
    for x, y in zip(a, b):
        assert torch.equal(x.prompt, y.prompt)
        assert (x.steps, x.traced) == (y.steps, y.traced)


def test_traffic_seeds_differ_in_order_not_in_sizes():
    a, b = requests(1), requests(2)
    assert any(x.prompt.shape != y.prompt.shape or x.steps != y.steps
               for x, y in zip(a, b))
    la = closed_loop.Traffic(MIX, 1, 50_000, "cpu")
    lb = closed_loop.Traffic(MIX, 2, 50_000, "cpu")
    n = len(la.prompt.values) * len(la.answer.values)
    for loop in (la, lb):
        assert loop.prompt.values.min() == MIX["prompt_len"][0]
        assert loop.answer.values.max() == MIX["answer_len"][1]
    # a whole sweep of every client holds each length equally often
    for k in (0, 3):
        for sweep in ("prompt", "answer"):
            got = [sorted(getattr(loop, sweep)(c, kk)
                          for c in range(MIX["clients"])
                          for kk in range(k, k + n))
                   for loop in (la, lb)]
            assert got[0] == got[1]
    # and the clients in flight at any one time hold them evenly
    for loop in (la, lb):
        now = [loop.answer(c, 5) for c in range(MIX["clients"])]
        assert abs(np.mean(now) - np.mean(loop.answer.values)) < 8


def test_closed_loop_joins_ramp_a_step_and_replaces_each_finished():
    loop = traffic.generator(MIX).Traffic(MIX, 3, 50_000, "cpu")
    assert loop.slots == MIX["clients"] * MIX["rows"]
    first = loop.due(0.0, 1)
    assert [r.client for r in first] == list(range(MIX["ramp"]))
    assert [r.client for r in loop.due(0.0, 1)] == []
    assert [r.client for r in loop.due(0.0, 3)] == list(
        range(MIX["ramp"], 3 * MIX["ramp"]))
    nxt = loop.after(first[1])
    assert [r.client for r in nxt] == [first[1].client]
    assert not loop.warmed
    loop.due(0.0, MIX["clients"])
    for c in range(MIX["clients"]):
        loop.after(traffic.Request(j=0, client=c, prompt=None, rows=1,
                                   prompt_len=1, steps=1, traced=False))
    assert loop.warmed


def test_mix_names_its_generator_and_keys(tmp_path):
    (tmp_path / "ralm_bench" / "traffic").mkdir(parents=True)
    path = tmp_path / "ralm_bench" / "traffic" / "m.json"
    path.write_text(json.dumps(MIX))
    assert traffic.load("m", tmp_path) == MIX
    path.write_text(json.dumps({k: v for k, v in MIX.items()
                                if k != "ramp"}))
    with pytest.raises(ValueError, match="ramp"):
        traffic.load("m", tmp_path)


def index(seed, residual=False):
    keys = torch.randn(ICFG["nlist"] + 256, 64,
                       generator=torch.Generator().manual_seed(0))
    return inputs.build_index(dict(ICFG, residual=residual), keys, 1000,
                              seed)


def test_index_same_seed_same_index():
    a, b = index(5), index(5)
    for name in ("codes", "ids", "lens", "payload", "centroids",
                 "codebooks"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_index_seeds_differ():
    a, b = index(5), index(6)
    assert not torch.equal(a.codes, b.codes)
    assert not torch.equal(a.lens, b.lens)
    assert not torch.equal(a.payload, b.payload)
    assert a.num_vectors == b.num_vectors == ICFG["num_vectors"]


@pytest.mark.parametrize("residual", [False, True])
def test_index_layout(residual):
    ix = index(7, residual)
    assert ix.residual == residual
    lens = ix.lens.sum(0).double()
    mean = ICFG["num_vectors"] / ICFG["nlist"]
    assert ix.num_vectors == ICFG["num_vectors"]
    assert float(lens.min()) >= mean * 0.8 - 1
    assert float(lens.max()) <= mean * 1.2 + 1
    assert ix.codes.shape[2] == int(ix.lens.max())
    # every id appears once, at the row the striping puts it
    ids = ix.ids[ix.ids >= 0]
    assert torch.equal(ids.sort().values,
                       torch.arange(ICFG["num_vectors"], dtype=torch.int32))
    some = torch.tensor([0, 1, 2, 12345, ICFG["num_vectors"] - 1])
    for gid in some.tolist():
        s, lst, row = (ix.ids == gid).nonzero()[0].tolist()
        assert torch.equal(ix.codes_of(torch.tensor([gid]))[0],
                           ix.codes[s, lst, row])
        assert int(ix.lists_of(torch.tensor([gid]))[0]) == lst


def test_sub_seeds_take_large_seeds():
    seeds = {inputs.sub_seed(s, "weights") for s in (0, 1, 2 ** 31 + 5,
                                                     2 ** 40)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 63 for s in seeds)
    assert np.unique([inputs.sub_seed(3, t) for t in ("a", "b")]).size == 2
