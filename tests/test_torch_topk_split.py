"""The rules the CUDA top-k's and shared scan's grids rest on, on the CPU.

The CUDA hierarchical top-k cuts each column block of a row into pieces,
a block each; a block's warps each keep the k' smallest keys (distance,
column) of their columns, warp 0 merges the warps' lists, the column
block's last piece merges the pieces' lists, and the row's last column
block merges the column blocks' lists into the k smallest. Here that
order of merges runs in torch, cut where the kernel cuts, and must equal
``ref_hierarchical_topk`` and the JAX ``approx_topk`` (its Pallas level-1
kernel in interpret mode) array for array, truncation included. Also
here: the host functions that pick the top-k's pieces and the shared
scan's tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.kernels.registry import PALLAS_INTERPRET
from repro.kernels.topk.ops import approx_topk as jax_approx_topk
from repro_torch.core.approx_topk_math import truncated_queue_len
from repro_torch.kernels.pq_adc import ops as pq
from repro_torch.kernels.topk import ops as tk
from repro_torch.kernels.topk.ref import ref_hierarchical_topk

INT_MAX = 2 ** 31 - 1
WARPS, STEP = 8, 512            # topk.cu: warps a block, columns a step


def _smallest(d, a, k):
    """The k smallest keys (distance, column) of d, a [rows, *], padded
    with (+inf, INT_MAX)."""
    o = torch.sort(a, dim=-1, stable=True).indices
    d, a = torch.gather(d, -1, o), torch.gather(a, -1, o)
    o = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    d, a = torch.gather(d, -1, o), torch.gather(a, -1, o)
    if d.shape[-1] < k:
        pad = (d.shape[0], k - d.shape[-1])
        d = torch.cat([d, torch.full(pad, float("inf"))], -1)
        a = torch.cat([a, torch.full(pad, INT_MAX, dtype=a.dtype)], -1)
    return d, a


def _merge(lists, k):
    return _smallest(torch.cat([x[0] for x in lists], -1),
                     torch.cat([x[1] for x in lists], -1), k)


def _piece_edges(tile, pieces, unit):
    """The kernel's piece boundaries: even cuts in units of 4 columns
    (16-byte loads) or 1."""
    units = tile // unit
    return [unit * (units * p // pieces) for p in range(pieces + 1)]


def _emulate(d, k, num_blocks, kp, pieces, unit):
    """topk.cu's order of selections and merges, in torch."""
    B, n = d.shape
    tile = n // num_blocks
    cols = torch.arange(n).expand(B, n)
    edges = _piece_edges(tile, pieces, unit)
    blocks = []
    for blk in range(num_blocks):
        lists = []
        for p in range(pieces):
            lo, hi = blk * tile + edges[p], blk * tile + edges[p + 1]
            warps = []
            for w in range(WARPS):             # warp w's steps of a piece
                idx = [c for s in range(lo + w * STEP, hi, WARPS * STEP)
                       for c in range(s, min(s + STEP, hi))]
                idx = torch.tensor(idx, dtype=torch.long)
                warps.append(_smallest(d[:, idx], cols[:, idx], kp))
            lists.append(_merge(warps, kp))
        blocks.append(_merge(lists, kp))
    out_d, out_a = _merge(blocks, k)
    return out_d, torch.where(torch.isinf(out_d), -1, out_a).int()


def _distances(seed, B, n):
    """Integer distances (many ties), a row of +inf, a +inf stretch, and
    one column block holding far more than k' of the row's smallest."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 40, size=(B, n)).astype(np.float32)
    d[1] = np.inf
    d[2, n // 3:n // 2] = np.inf
    d[3, :n // 8] = rng.integers(-9, -5, size=n // 8)
    return d


@pytest.mark.parametrize("B,n,k,num_blocks,k_prime,pieces,unit", [
    (8, 4096, 40, 4, None, 3, 4),
    (8, 4096, 100, 8, 15, 5, 4),
    (8, 2048, 20, 8, 3, 2, 1),
    (8, 3000, 4, 4, 1, 7, 1),
    (8, 4096, 129, 2, None, 1, 4),
])
def test_piece_merges_equal_plain_and_jax(B, n, k, num_blocks, k_prime,
                                          pieces, unit):
    d = _distances(B * n + k, B, n)
    kp = k_prime or truncated_queue_len(k, num_blocks)
    kp = min(max(kp, 1), k)
    got = _emulate(torch.from_numpy(d), k, num_blocks, kp, pieces, unit)
    plain = ref_hierarchical_topk(torch.from_numpy(d), k, num_blocks, kp)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[0], plain[0])
    jd, ji = jax_approx_topk(jnp.asarray(d), k, num_blocks=num_blocks,
                             k_prime=kp, spec=PALLAS_INTERPRET)
    np.testing.assert_array_equal(got[1].numpy(), np.array(ji))
    np.testing.assert_array_equal(got[0].numpy(), np.array(jd))
    port = tk.approx_topk(torch.from_numpy(d), k, num_blocks=num_blocks,
                          k_prime=kp)
    assert torch.equal(port[1], plain[1])


def test_truncation_is_kept():
    """Row 3's smallest lie in one column block: the hierarchy keeps k' of
    them, and the emulated kernel does too."""
    d = torch.from_numpy(_distances(5, 8, 4096))
    got = _emulate(d, 40, 8, 5, 3, 4)
    exact = torch.sort(d[3], stable=True)
    assert not torch.equal(got[0][3], exact.values[:40])
    assert torch.equal(got[1], ref_hierarchical_topk(d, 40, 8, 5)[1])


@given(B=st.integers(1, 64), num_blocks=st.integers(1, 64),
       tile=st.integers(1, 1 << 20), k=st.integers(1, tk.MAX_K),
       sms=st.integers(1, 264))
def test_topk_pieces_stay_in_bounds(B, num_blocks, tile, k, sms):
    pieces = tk.topk_pieces(B, num_blocks, tile, k, sms)
    assert pieces >= 1
    if k > tk.WARP_MAX_K:
        assert pieces == 1
    if pieces > 1:
        assert tile // pieces >= tk.MIN_PIECE_COLS
        assert B * num_blocks * (pieces - 1) < tk.BLOCKS_PER_SM * sms
    for unit in (1, 4):
        if unit == 4 and tile % 4:
            continue
        edges = _piece_edges(tile, pieces, unit)
        assert edges[0] == 0 and edges[-1] == tile
        assert all(b - a >= unit * (tile // unit // pieces)
                   for a, b in zip(edges, edges[1:]))


def test_topk_pieces_at_the_smoke_shape():
    """32 rows x 16 column blocks of 29 952 columns on 132 SMs already
    make 512 blocks: one piece each. 4 rows x 4 column blocks of the
    same width: 25 pieces wanted, 7 of at least 4 096 columns allowed."""
    assert tk.topk_pieces(32, 16, 29952, 100, 132) == 1
    assert tk.topk_pieces(4, 4, 29952, 100, 132) == 7


@pytest.mark.parametrize("ksub", [2, 16, 64, 256])
def test_shared_tile_q_fits_shared_memory(ksub):
    for m in (1, 4, 8, 12, 16, 32, 48, 64, 96, 128, 224):
        lut_bytes = m * ksub * 4
        for q in (1, 2, 3, 5, 32):
            if lut_bytes > pq.SMEM_LIMIT:
                with pytest.raises(ValueError):
                    pq.shared_tile_q(q, m, ksub)
                continue
            tq = pq.shared_tile_q(q, m, ksub)
            assert tq in (1, 2, 4) and tq * lut_bytes <= pq.SMEM_LIMIT
            assert tq // 2 < q                  # no tile of idle queries
            assert pq.shared_tile_q(q, m, ksub, cap=1) == 1


def test_shared_tile_q_at_the_smoke_shape():
    """m = 32, ksub = 256: four 32 KB LUTs a block, 8 query tiles for 32
    queries; m = 64 halves it."""
    assert pq.shared_tile_q(32, 32, 256) == 4
    assert pq.shared_tile_q(32, 64, 256) == 2
    assert pq.shared_tile_q(32, 128, 256) == 1


@given(n=st.integers(0, (1 << 31) - 1), tiles=st.integers(1, 64),
       sms=st.integers(1, 264))
def test_shared_rows_stay_in_bounds(n, tiles, sms):
    rows = pq.shared_rows(n, tiles, sms)
    chunks = -(-n // rows)
    assert rows >= 1 and chunks <= 65535
    if chunks > 1 and rows > -(-n // 65535):
        assert tiles * (chunks - 1) < pq.SHARED_BLOCKS_PER_SM * sms
        assert rows >= pq.MIN_SHARED_ROWS
