"""The dense assigned backbones served by the port's engine against the
JAX engine, end to end on the CPU, and through the port's launcher.

Each backbone at its reduced size (vocab 64) serves the kNN-LM recipe of
``tests/test_serve.py`` (a deterministic-bigram corpus, k 8, lam 0.999)
from a datastore the reference's ``DatastoreBuilder`` built and the port
converted, as does the LM: its QKV biases (Qwen2, Qwen2-VL) are set to
seeded non-zero values first. Greedy tokens through the wave engine
(fused scan synchronous and asynchronous, the staged scan) must equal
the JAX engine's, and so must those of the LM alone (``mode="none"``),
since with lam 0.999 retrieval would set the tokens even under a wrong
LM. Prompts of 12 and 9 tokens with 10 and 8 steps run Gemma-3's 8-slot
local rings round in prefill and again in decode. Gemma-3 and
Qwen2-VL serve in ``test_torch_assigned_serve_ring.py`` (one file per
worker stays short).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import transformer as jtf
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro_torch import convert
from repro_torch.serve import EngineConfig, RagConfig, RalmEngine, RalmRequest
from test_torch_assigned_archs import seeded_biases

ARCHS = ("qwen2_0_5b", "phi3_mini_3_8b", "llama3_405b")
MODES = ("wave_sync", "wave_async", "staged", "lm_alone")
PROMPTS = ((slice(0, 2), 12, 10), (slice(2, 5), 9, 8))   # rows, T0, steps


def _corpus():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        seqs.append((3 * seqs[-1] + 1) % 64)
    return np.stack(seqs, axis=1).astype(np.int32)         # [64 docs, 32]


def make_backbone(arch):
    """The reduced backbone at vocab 64 (seeded biases), its datastore
    over the bigram corpus, and both converted."""
    cfg = dataclasses.replace(get_arch(arch).reduced, vocab_size=64)
    params = seeded_biases(jtf.init_params(jax.random.PRNGKey(0), cfg), cfg)
    corpus = _corpus()
    ds = JaxBuilder(dim=cfg.d_model, nlist=8, m=8,
                    list_cap=512).from_corpus(params, cfg, corpus)
    tcfg = convert.model_config(dataclasses.asdict(cfg))
    tds = convert.datastore(
        dataclasses.asdict(ds.index_cfg), np.array(ds.params.coarse_centroids),
        np.array(ds.params.codebooks),
        [(np.array(s.codes), np.array(s.ids), np.array(s.list_len))
         for s in ds.shards],
        payload_tokens=np.array(ds.payload_tokens),
        num_vectors=ds.num_vectors)
    tparams = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), params),
        tcfg)
    return dict(arch=arch, cfg=cfg, params=params, corpus=corpus, ds=ds,
                tcfg=tcfg, tparams=tparams, tds=tds)


@pytest.fixture(scope="module", params=ARCHS)
def backbone(request):
    return make_backbone(request.param)


def _run(engine, request_cls, conv, corpus):
    rids = [engine.submit(request_cls(prompt=conv(corpus[rows, :t0]),
                                      steps=steps))
            for rows, t0, steps in PROMPTS]
    by_id = {r.request_id: np.asarray(r.tokens) for r in engine.run()}
    return [by_id[r] for r in rids]


def check_greedy(t, mode):
    """One engine of each package at ``mode``: the same greedy tokens
    and decode waves."""
    rag = dict(mode="knnlm", interval=1, k=8, lam=0.999, temperature=1.0)
    if mode == "lm_alone":
        rag["mode"] = "none"
    fused = mode != "staged"
    async_retrieval = mode != "wave_sync"
    jeng = JaxEngine.from_config(
        JaxEngineConfig(model=t["cfg"], rag=JaxRagConfig(**rag),
                        async_retrieval=async_retrieval, kernel_fused=fused),
        t["params"], t["ds"], t["ds"].search_config(nprobe=4, k=8))
    teng = RalmEngine.from_config(
        EngineConfig(model=t["tcfg"], rag=RagConfig(**rag),
                     async_retrieval=async_retrieval),
        t["tparams"], t["tds"],
        t["tds"].search_config(nprobe=4, k=8, fused=fused), device="cpu")
    jout = _run(jeng, JaxRequest, jnp.asarray, t["corpus"])
    tout = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    assert teng.decode_dispatches == jeng.decode_dispatches == 9
    if mode == "staged":
        st = teng.retriever.service.stats
        assert st.scan_dispatches == t["tds"].num_shards * st.num_batches
    if t["cfg"].window:
        assert teng.pool.caches["classes"]["local"]["k"].shape[2] == \
            t["cfg"].window < PROMPTS[0][1]


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_match_jax_engine(backbone, mode):
    check_greedy(backbone, mode)


def test_launcher_serves_assigned_backbones(capsys):
    """``--arch qwen2_0_5b``, ``rwkv6_3b`` (recurrent state in the pool)
    and ``phi3_5_moe_42b`` (MoE) serve through the launcher, reduced on
    the CPU; SeamlessM4T, a RETRO encoder-decoder, is refused before
    anything is built (the launcher's datastore has no chunk table)."""
    from repro_torch.launch import serve as launch

    for arch in ("qwen2_0_5b", "rwkv6_3b", "phi3_5_moe_42b"):
        launch.main(["--arch", arch, "--device", "cpu", "--reduced",
                     "--steps", "2", "--requests", "1"])
        assert "[serve] wave: 1 batches, 4 tokens" in \
            capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch.parse_args(["--arch", "seamless_m4t_medium", "--device",
                           "cpu"])
    assert "no chunk table" in capsys.readouterr().err
