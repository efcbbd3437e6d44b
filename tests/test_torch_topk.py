"""The port's approximate hierarchical top-k against the JAX package, on
the CPU.

``approx_topk`` takes its plain versions here; the same numpy-seeded
distances go through the JAX ``approx_topk`` with the Pallas level-1
kernel in interpret mode. Results must be equal, array for array.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.registry import PALLAS_INTERPRET
from repro.kernels.topk.ops import approx_topk as jax_approx_topk
from repro.kernels.topk.ref import ref_exact_topk as jax_exact_topk
from repro_torch.kernels.topk import ops as ttk
from repro_torch.kernels.topk.ref import ref_exact_topk


def _assert_same(port, jax_out):
    np.testing.assert_array_equal(port[1].numpy(), np.array(jax_out[1]))
    np.testing.assert_array_equal(port[0].numpy(), np.array(jax_out[0]))


@pytest.mark.parametrize("k,num_blocks", [(1, 4), (10, 8), (25, 4),
                                          (40, 16)])
def test_approx_topk_matches_jax_pallas(k, num_blocks):
    d = np.random.default_rng(k * num_blocks).normal(
        size=(8, 512)).astype(np.float32)
    port = ttk.approx_topk(torch.from_numpy(d), k, num_blocks=num_blocks)
    _assert_same(port, jax_approx_topk(jnp.asarray(d), k,
                                       num_blocks=num_blocks,
                                       spec=PALLAS_INTERPRET))
    assert port[1].dtype == torch.int32


def test_approx_topk_ties_and_explicit_k_prime():
    """Integer distances tie often: the lower column wins inside a block
    and across blocks. k' is given explicitly, below the binomial
    sizing, so the truncation really drops members."""
    d = np.random.default_rng(9).integers(0, 6, size=(8, 512)
                                          ).astype(np.float32)
    port = ttk.approx_topk(torch.from_numpy(d), 20, num_blocks=8, k_prime=3)
    _assert_same(port, jax_approx_topk(jnp.asarray(d), 20, num_blocks=8,
                                       k_prime=3, spec=PALLAS_INTERPRET))


def test_inf_padding_gives_minus_one():
    d = np.full((8, 256), np.inf, np.float32)
    d[:, :3] = np.arange(3, dtype=np.float32)
    dd, ii = ttk.approx_topk(torch.from_numpy(d), 5, num_blocks=4)
    assert (ii[:, 3:] == -1).all() and torch.isinf(dd[:, 3:]).all()
    assert torch.equal(ii[:, :3], torch.arange(3, dtype=torch.int32
                                               ).expand(8, 3))
    _assert_same((dd, ii), jax_approx_topk(jnp.asarray(d), 5, num_blocks=4,
                                           spec=PALLAS_INTERPRET))


def test_degenerate_tiling_is_the_exact_topk():
    """500 % 16 != 0: the reference returns the exact top-k."""
    d = np.random.default_rng(3).normal(size=(4, 500)).astype(np.float32)
    port = ttk.approx_topk(torch.from_numpy(d), 10, num_blocks=16)
    _assert_same(port, jax_exact_topk(jnp.asarray(d), 10))
    # blocks shorter than k' are degenerate too
    port = ttk.approx_topk(torch.from_numpy(d[:, :64]), 10, num_blocks=16)
    _assert_same(port, jax_exact_topk(jnp.asarray(d[:, :64]), 10))


def test_row_exactness_rate():
    """The binomial sizing of k' (eps = 0.01) keeps >= 99 % of random
    rows identical to the exact top-k."""
    d = torch.from_numpy(np.random.default_rng(7).normal(
        size=(256, 2048)).astype(np.float32))
    da, _ = ttk.approx_topk(d, 100, num_blocks=16, eps=0.01)
    de, _ = ref_exact_topk(d, 100)
    _assert_same((de, _), jax_exact_topk(jnp.asarray(d.numpy()), 100))
    row_exact = (da == de).all(dim=1).float().mean().item()
    assert row_exact >= 0.99, row_exact
