"""The plain reference held against the port at a reduced width on the
CPU: the dense decoder's hidden states and logits (the port in float32),
the IVF-PQ search over the benchmark's index layout, the per-shard queue
length and the kNN-LM mix."""
import pytest
import torch

from ralm_bench import inputs
from ralm_bench.reference import dense_decoder, search

MODEL = dict(name="tiny", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
             d_head=16, d_ff=96, vocab_size=300, rope_theta=10000.0,
             norm_eps=1e-5, tie_embeddings=False, dtype="float32")
ICFG = dict(num_vectors=8192, nlist=32, m=8, nbits=8, num_shards=2,
            nprobe=6, eps=0.01, list_spread=0.2, centroid_noise=0.25)


@pytest.fixture(scope="module")
def params():
    return dense_decoder.make_weights(MODEL, dict(std=0.1, embed_std=0.4,
                                                  lm_head_std=0.2), 11, "cpu")


def port_forward(params, tokens):
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(**MODEL)
    logits, _, h = tf.forward(params, cfg, tokens, mode="train",
                              return_hidden=True)
    return h, logits


def test_dense_decoder_matches_the_port(params):
    tokens = torch.randint(0, 300, (3, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h_port, lg_port = port_forward(params, tokens)
        h = dense_decoder.hidden_states(params, MODEL, tokens)
        lg = dense_decoder.logits(params, MODEL, h)
    torch.testing.assert_close(h, h_port, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lg, lg_port, rtol=1e-4, atol=1e-4)


def test_fp8_control_departs(params):
    tokens = torch.randint(0, 300, (2, 24),
                           generator=torch.Generator().manual_seed(2))
    h = dense_decoder.hidden_states(params, MODEL, tokens)
    h8 = dense_decoder.hidden_states(params, MODEL, tokens, quant="fp8")
    rel = float((h8 - h).norm() / h.norm())
    assert 1e-3 < rel < 0.5


@pytest.fixture(scope="module", params=[False, True],
                ids=["flat", "residual"])
def index(request):
    keys = torch.randn(ICFG["nlist"] + 256, 64,
                       generator=torch.Generator().manual_seed(3))
    return inputs.build_index(dict(ICFG, residual=request.param), keys, 300,
                              4)


def test_search_matches_the_port(index):
    from repro_torch.core.chamvs import ChamVSConfig, stack_shards
    from repro_torch.core.ivfpq import IVFPQConfig, IVFPQParams, IVFPQShard
    from repro_torch.retrieval.service import search_stacked
    ivf = IVFPQConfig(dim=64, nlist=ICFG["nlist"], m=8,
                      residual=index.residual,
                      list_cap=index.codes.shape[2])
    cfg = ChamVSConfig(ivfpq=ivf, nprobe=ICFG["nprobe"], k=20,
                       eps=ICFG["eps"])
    stacked = stack_shards([IVFPQShard(index.codes[s], index.ids[s],
                                       index.lens[s]) for s in range(2)])
    q = index.centroids[:16] + 0.1 * torch.randn(
        16, 64, generator=torch.Generator().manual_seed(5))
    d_port, i_port = search_stacked(
        IVFPQParams(index.centroids, index.codebooks), stacked, q, cfg)
    d_ref, i_ref = search.search(index, q, ICFG["nprobe"], 20, ICFG["eps"])
    torch.testing.assert_close(d_ref, d_port, rtol=1e-5, atol=1e-4)
    same = (i_ref[:, :, None] == i_port[:, None, :]).any(-1).float().mean()
    assert float(same) >= 0.99
    # the distances of the port's ids, recomputed by the reference
    torch.testing.assert_close(search.distances_of(index, q, i_port),
                               d_port, rtol=1e-5, atol=1e-4)


def test_k_prime_matches_the_port():
    from repro_torch.core.approx_topk_math import truncated_queue_len
    for K, S, eps in ((100, 2, 0.01), (100, 4, 0.01), (10, 2, 0.05),
                      (64, 1, 0.01)):
        assert search.k_prime(K, S, eps) == truncated_queue_len(K, S, eps)


def test_knn_mix_matches_the_port():
    from repro_torch.core.rag import knnlm_interpolate
    g = torch.Generator().manual_seed(6)
    logits = torch.randn(5, 50, generator=g) * 3
    dists = torch.rand(5, 8, generator=g) * 40
    toks = torch.randint(0, 50, (5, 8), generator=g)
    toks[0, 3] = -1
    dists[1] = float("inf")
    want = knnlm_interpolate(logits, dists, toks, 0.25, 10.0)
    got = search.knn_mix(logits, dists, toks, 0.25, 10.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
