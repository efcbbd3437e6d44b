"""The port's ``KVCachePool``: the pool assertions of ``tests/test_kvpool.py``
and ``tests/test_decode_attn.py::test_pool_seq_block_alignment``, replayed
on ``repro_torch.serve.kvpool``; each pool is built beside the
reference's and both must agree."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.serve import KVCachePool as JaxPool
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tf
from repro_torch.serve import KVCachePool


def _cfg():
    return dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)


def _jcfg():
    return dataclasses.replace(jax_arch("dec_s").reduced, vocab_size=64)


def test_pool_slot_lifecycle():
    pool = KVCachePool(_cfg(), capacity=4, max_seq=16)
    assert pool.num_free == 4 and pool.scratch == 4
    a = pool.alloc(2)
    b = pool.alloc(1)
    assert a.tolist() == [0, 1] and b.tolist() == [2]
    assert pool.num_used == 3
    pool.release(a)
    assert pool.alloc(2).tolist() == [0, 1]          # lowest ids first
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(2)
    assert pool.bucket(3) == 4 and pool.bucket(4) == 4 and pool.bucket(5) == 8


def test_pool_fixed_capacity_cannot_grow():
    pool = KVCachePool(_cfg(), capacity=2, max_seq=8, fixed=True)
    with pytest.raises(RuntimeError, match="fixed"):
        pool.grow_slots(4)


def test_pool_growth_preserves_written_rows():
    cfg = _cfg()
    pool = KVCachePool(cfg, capacity=2, max_seq=8)
    caches = tf.init_cache(cfg, 1, max_seq=8)
    marked = {"classes": {c: {k: torch.ones_like(v) for k, v in d.items()}
                          for c, d in caches["classes"].items()}}
    slots = pool.alloc(1)
    pool.write_prefill(slots, marked)
    pool.grow_slots(4)
    pool.grow_seq(12)
    assert pool.capacity == 4 and pool.max_seq == 12
    k = pool.caches["classes"][cfg.layer_pattern[0]]["k"]
    assert k.shape[1] == 5 and k.shape[2] == 12
    assert bool((k[:, slots[0], :8] == 1).all())       # written prefix intact
    assert bool((k[:, slots[0], 8:] == 0).all())       # extension zeroed
    assert bool((k[:, 1:] == 0).all())
    assert pool.num_free == 3                          # old scratch + growth


def test_pool_seq_block_alignment_matches_reference():
    pools = [KVCachePool(_cfg(), capacity=2, max_seq=20, seq_block=16),
             JaxPool(_jcfg(), capacity=2, max_seq=20, seq_block=16)]
    for pool in pools:
        assert pool.max_seq == 32
        assert pool.caches["classes"]["global"]["k"].shape[2] == 32
        pool.grow_seq(33)
        assert pool.max_seq == 48
        assert pool.attn_len(3, bucket=2) == 16
        assert pool.attn_len(16, bucket=2) == 32
        assert pool.attn_len(200, bucket=2) == 48
        st = pool.stats
        assert st.blocks_total == 9 and st.blocks_skipped == 3
        assert st.compiled == {(2, 16, 2, 48), (2, 32, 2, 48),
                               (2, 48, 2, 48)}
        pool.grow_seq(64)
        assert pool.attn_len(3, bucket=2) == 16
        assert st.decode_compiles == 4
    assert pools[0].stats.skip_fraction() == pools[1].stats.skip_fraction()


def test_pad_wave_matches_reference():
    tp = KVCachePool(_cfg(), capacity=8, max_seq=16)
    jp = JaxPool(_jcfg(), capacity=8, max_seq=16)
    slots = np.array([3, 0, 5], np.int32)
    pos = np.array([7, 2, 9], np.int32)
    tt, ts, tpos = tp.pad_wave(torch.tensor([[1], [2], [3]]), slots, pos)
    jt, js, jpos = jp.pad_wave(jnp.asarray([[1], [2], [3]]), slots, pos)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert ts.tolist() == js.tolist() == [3, 0, 5, 8]
    assert tpos.tolist() == jpos.tolist() == [7, 2, 9, 0]
    assert tp.stats.mean_wave() == jp.stats.mean_wave() == 3.0
    assert tp.stats.buckets == jp.stats.buckets == {4}
