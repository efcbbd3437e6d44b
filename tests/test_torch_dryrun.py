"""The dry run's steps and cost counter against the JAX package, on the
CPU:

  * ``build_prefill_step`` and ``build_serve_step`` against the
    reference's jitted steps on a one-device mesh, at reduced Dec-S (the
    kNN-LM mix) and reduced EncDec-S (the RETRO re-encode) in float32,
    with small real inputs (the reference's ``SHAPES`` entries are
    patched to a small batch and cache; no file of the reference
    changes): last-position logits, log-probs and caches within 1e-5
    relative, the search's ids exact against the reference's
    ``router.build_search``;
  * the counter's FLOPs of those steps without retrieval against
    ``repro.launch.analysis.analyze_hlo`` of the compiled JAX steps:
    within 2 %;
  * ``ModelConfig.active_param_count`` and the records' ``model_flops``
    equal the reference's formula for every model;
  * ``run_cell`` at full width for ``decode_32k`` of Llama-3-405B,
    Qwen2-VL-72B, DBRX-132B and Phi-3.5-MoE (32 layers) on both
    production meshes: ``OK``, ``arg_bytes_per_dev`` equal to the sum
    the reference's specs and jax's ``NamedSharding.shard_shape`` give,
    process RSS grown by less than 1 GB, and CUDA never initialised; a
    skip-listed shape gives ``SKIP``;
  * every kernel wrapper on meta tensors returns the plain version's
    shapes and dtypes, and raises on a device that is neither CPU, meta
    nor CUDA.
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
from repro.configs import get_arch as jax_arch
from repro.core import ivfpq as jivf
from repro.core.chamvs import stack_shards as jstack
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.launch.analysis import analyze_hlo
from repro.launch.mesh import make_mesh_for
from repro.models import sharding as jsharding
from repro.models import transformer as jtf
from repro.retrieval import router as jrouter
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.core.ivfpq import IVFPQShard
from repro_torch.kernels.chamvs_scan import ops as cs
from repro_torch.kernels.decode_attn import ops as da
from repro_torch.kernels.ivf_scan import ops as iv
from repro_torch.kernels.pq_adc import ops as pq
from repro_torch.kernels.topk import ops as tk
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.analysis import count_cost
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as ttf

REL = dict(rtol=1e-5, atol=1e-5)
B, T0, S = 4, 16, 32                    # batch, prompt, cache
SMALL = {"prefill_32k": dict(kind="prefill", seq_len=S, global_batch=B),
         "decode_32k": dict(kind="decode", seq_len=S, global_batch=B)}
N_VEC = 2048                             # vectors indexed
DB = dict(n_vectors=4096, nlist=16, nprobe=4)


def _np(x):
    return np.array(x)


@pytest.fixture
def small_shapes(monkeypatch):
    for table in (jconfigs.SHAPES, SHAPES):
        for name, sh in SMALL.items():
            monkeypatch.setitem(table, name, sh)


def _specs(name):
    """The reduced model in float32, as an ArchSpec of both packages."""
    j, t = jax_arch(name), get_arch(name)
    return (dataclasses.replace(j, model=dataclasses.replace(
                j.reduced, dtype="float32")),
            dataclasses.replace(t, model=dataclasses.replace(
                t.reduced, dtype="float32")))


def _jax_mesh():
    return make_mesh_for(jax.devices()[:1], data=1)


def _port_mesh():
    return Mesh(("data", "model"), (1, 1), ("cpu",))


def _inputs(jspec, seed=0):
    cfg, rng = jspec.model, np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T0)).astype(np.int32)
    batch = {"tokens": tokens,
             "positions": np.broadcast_to(np.arange(T0, dtype=np.int32),
                                          (B, T0)).copy()}
    dec = {"token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
           "position": np.full((B,), T0, np.int32)}
    if cfg.arch == "encdec":
        enc = jspec.rag.k * jspec.rag.chunk_len
        batch["enc_embeds"] = rng.standard_normal(
            (B, enc, cfg.d_model)).astype(np.float32)
        dec["enc_states"] = rng.standard_normal(
            (B, enc, cfg.d_model)).astype(np.float32)
    return batch, dec


def _db(ccfg, jspec, seed=1):
    """A one-shard residual index at the step's config (the reference's
    train_ivfpq / build_shards), its payload table, both packages'."""
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((N_VEC, ccfg.ivfpq.dim)).astype(np.float32)
    params = jivf.train_ivfpq(jax.random.PRNGKey(0), jnp.asarray(vecs),
                              ccfg.ivfpq, kmeans_iters=4)
    stacked = jstack(jivf.build_shards(params, vecs, ccfg.ivfpq, 1))
    vocab = jspec.model.vocab_size
    payload = (rng.integers(0, vocab, (DB["n_vectors"],))
               if jspec.rag.mode == "knnlm" else
               rng.integers(0, vocab, (DB["n_vectors"],
                                       jspec.rag.chunk_len))
               ).astype(np.int32)
    tparams = convert.ivfpq_params(_np(params.coarse_centroids),
                                   _np(params.codebooks))
    tstacked = IVFPQShard(*(torch.from_numpy(_np(x)) for x in stacked))
    return ((params, stacked, jnp.asarray(payload)),
            (tparams, tstacked, torch.from_numpy(payload)))


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _cache_pair(jspec, tcfg):
    enc = (jspec.rag.k * jspec.rag.chunk_len
           if jspec.model.arch == "encdec" else 0)
    return (jtf.init_cache(jspec.model, B, max_seq=S, enc_len=enc),
            ttf.init_cache(tcfg, B, max_seq=S, enc_len=enc))


def _assert_tree_close(t_tree, j_tree):
    got, want = tree_lib.keyed(t_tree), tree_lib.keyed(
        jax.tree.map(_np, j_tree))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], **REL, err_msg=k)


@pytest.mark.parametrize("arch", ["dec_s", "encdec_s"])
def test_steps_match_the_jax_steps(small_shapes, arch):
    jspec, tspec = _specs(arch)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jspec.model)
    tparams = convert.lm_params(jax.tree.map(_np, jparams), tspec.model)
    jm, tm = _jax_mesh(), _port_mesh()
    batch, dec = _inputs(jspec)

    jpre, _ = jsteps.build_prefill_step(jspec, "prefill_32k", jm)
    tpre, _ = tsteps.build_prefill_step(tspec, "prefill_32k", tm)
    jc, tc = _cache_pair(jspec, tspec.model)
    jlog, jc = jpre(jparams, jc, _j(batch))
    tlog, tc = tpre(tparams, tc, _t(batch))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **REL)
    _assert_tree_close(tc, jc)

    jdb, tdb = jspecs.ServeDBSpec(**DB), tspecs.ServeDBSpec(**DB)
    jserve, _, (jccfg, _) = jsteps.build_serve_step(jspec, "decode_32k", jm,
                                                    db=jdb)
    tserve, _, (tccfg, _) = tsteps.build_serve_step(tspec, "decode_32k", tm,
                                                    db=tdb)
    assert dataclasses.asdict(tccfg.ivfpq) == dataclasses.asdict(jccfg.ivfpq)
    (jdp, jds, jpay), (tdp, tds, tpay) = _db(jccfg, jspec)
    jout, jc = jserve(jparams, jc, _j(dec), jdp, jds, jpay)
    tout, tc = tserve(tparams, tc, _t(dec), tdp, tds, tpay)
    assert tout.dtype == torch.float32 and tout.shape == (
        B, tspec.model.vocab_size)
    np.testing.assert_allclose(tout.numpy(), _np(jout), **REL)
    _assert_tree_close(tc, jc)

    # the search alone: the reference's distributed search on the mesh
    q = np.random.default_rng(2).standard_normal(
        (B, jccfg.ivfpq.dim)).astype(np.float32)
    jsearch = jrouter.build_search(jm, jccfg, db_axes=("data",),
                                   query_axis="model", nq=B)
    d0, i0 = jsearch(jdp, jds, jnp.asarray(q))
    d, i = tserve.search(tdp, tds, torch.from_numpy(q))
    np.testing.assert_array_equal(i.numpy(), _np(i0))
    np.testing.assert_allclose(d.numpy(), _np(d0), **REL)


def _padded(x: int, block: int = 512) -> int:
    b = min(block, x)
    return -(-x // b) * b


def reference_padding_flops(spec, kind: str) -> int:
    """The FLOPs the reference's ``flash_attention`` spends on padding:
    it pads queries and keys to whole blocks of min(512, length) (an
    encoder-decoder's 640 retrieved rows to 1024), where the port's last
    block is shorter. Each (query rows, key rows) call costs
    4 B H D Tq Tk in its two products: in prefill the encoder's
    self-attention and the decoder's cross-attention over the encoder
    rows, in decode the cross-attention of the one new token."""
    cfg = spec.model
    if cfg.arch != "encdec":
        return 0
    enc = spec.rag.k * spec.rag.chunk_len
    calls = ([(enc, enc)] * cfg.n_enc_layers + [(T0, enc)] * cfg.n_layers
             if kind == "prefill" else [(1, enc)] * cfg.n_layers)
    return sum(4 * B * cfg.n_heads * cfg.d_head
               * (_padded(tq) * _padded(tk) - tq * tk) for tq, tk in calls)


@pytest.mark.parametrize("arch", ["dec_s", "encdec_s"])
def test_counted_flops_match_analyze_hlo(small_shapes, arch):
    """FLOPs of the prefill step and of the serve step without
    retrieval: the port's eager ops counted by FlopCounterMode against
    the dots of the compiled JAX program, within 2 % once the
    reference's block padding (``reference_padding_flops``, counted op
    by op) is added to the port's count."""
    jspec, tspec = _specs(arch)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jspec.model)
    tparams = convert.lm_params(jax.tree.map(_np, jparams), tspec.model)
    jm, tm = _jax_mesh(), _port_mesh()
    batch, dec = _inputs(jspec)
    jc, tc = _cache_pair(jspec, tspec.model)
    jpre, _ = jsteps.build_prefill_step(jspec, "prefill_32k", jm)
    tpre, _ = tsteps.build_prefill_step(tspec, "prefill_32k", tm)
    jserve, _, _ = jsteps.build_serve_step(jspec, "decode_32k", jm,
                                           with_retrieval=False)
    tserve, _, _ = tsteps.build_serve_step(tspec, "decode_32k", tm,
                                           with_retrieval=False)
    for kind, jstep, tstep, jargs, targs in (
            ("prefill", jpre, tpre, (jparams, jc, _j(batch)),
             (tparams, tc, _t(batch))),
            ("decode", jserve, tserve, (jparams, jc, _j(dec)),
             (tparams, tc, _t(dec)))):
        want = analyze_hlo(jstep.lower(*jargs).compile().as_text()).flops
        _, cost = count_cost(tstep, *targs)
        pad = reference_padding_flops(jspec, kind)
        assert want > 0
        assert abs(cost.flops + pad - want) <= 0.02 * want, \
            (cost.flops, pad, want)
        # the same count on meta tensors (no data): the dry run's case
        meta = tree_lib.map(lambda x: x.to("meta"), targs)
        _, mcost = count_cost(tstep, *meta)
        assert mcost.flops == cost.flops and mcost.bytes == cost.bytes


def test_model_flops_and_active_params_match_the_reference():
    for arch in list_archs(include_paper=True):
        jcfg, tcfg = jax_arch(arch).model, get_arch(arch).model
        assert tcfg.active_param_count() == jcfg.active_param_count(), arch
        assert tcfg.param_count() == jcfg.param_count(), arch
    rec = dryrun.run_cell("phi3_5_moe_42b", "decode_32k", multi_pod=False)
    jcfg = jax_arch("phi3_5_moe_42b").model
    assert rec["model_flops"] == 2.0 * jcfg.active_param_count() * 128
    assert jcfg.active_param_count() < jcfg.param_count()


def _reference_arg_bytes(arch, multi):
    """The serve step's argument bytes per device from the reference's
    specs (sanitised as its jit needs them) and structs, each leaf's
    local shape from jax's NamedSharding over an AbstractMesh."""
    axes = ("pod", "data", "model") if multi else ("data", "model")
    dims = (2, 16, 16) if multi else (16, 16)
    stand_in = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(dims, dtype=object),
                                     shape=dict(zip(axes, dims)))
    am = AbstractMesh(dims, axes)
    spec = jax_arch(arch)
    cfg, shape = spec.model, "decode_32k"
    dp = jsharding.dp_axes(stand_in)
    n = jspecs.num_db_shards(stand_in)
    ccfg = jspecs.ServeDBSpec().for_model(cfg, n, spec.rag.k)
    p_struct = jsharding._as_shape_tree(cfg)
    c_struct = jspecs.cache_struct(spec, shape)
    dbp, dbs = jspecs.db_struct(ccfg, n)
    dbp_s, dbs_s = jspecs.db_specs(stand_in)
    parts = [
        (p_struct, jsharding.param_specs(cfg, stand_in)),
        (c_struct, jsharding.cache_specs(cfg, stand_in, c_struct)),
        (jspecs.decode_struct(spec, shape),
         {"token": JP(dp, None), "position": JP(dp)}),
        (dbp, dbp_s), (dbs, dbs_s),
        (jax.ShapeDtypeStruct((10 ** 9,), jnp.int32), JP(dp + ("model",)))]
    if cfg.d_model != ccfg.ivfpq.dim:
        parts.append((jax.ShapeDtypeStruct((cfg.d_model, ccfg.ivfpq.dim),
                                           jnp.float32), JP(None, "model")))
    total = 0
    for struct, specs in parts:
        specs = jsharding.sanitize(specs, struct, stand_in)
        leaves = jax.tree.leaves(struct)
        flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
        assert len(leaves) == len(flat)
        for leaf, s in zip(leaves, flat):
            local = NamedSharding(am, s).shard_shape(leaf.shape)
            total += math.prod(local) * np.dtype(leaf.dtype).itemsize
    return total


def _rss() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


@pytest.mark.parametrize("arch", ["llama3_405b", "qwen2_vl_72b", "dbrx_132b",
                                  "phi3_5_moe_42b"])
def test_full_width_decode_cells_allocate_nothing(arch):
    assert get_arch(arch).model.n_layers >= 32
    rss0 = _rss()
    for multi in (False, True):
        rec = dryrun.run_cell(arch, "decode_32k", multi_pod=multi)
        assert rec["status"] == "OK", rec
        assert rec["n_devices"] == (512 if multi else 256)
        assert rec["retrieval"] and rec["per_dev_rule"] == "even split"
        assert rec["arg_bytes_per_dev"] == _reference_arg_bytes(arch, multi)
        assert rec["hlo_flops_per_dev"] > 0 and rec["hlo_bytes_per_dev"] > 0
        assert rec["collective_bytes_per_dev"] is None
        assert rec["collective_s"] is None and rec["compile_s"] is None
        assert rec["dominant"] is None and rec["roofline_fraction"] is None
        assert rec["compute_s"] > 0 and rec["memory_s"] > 0
    assert _rss() - rss0 < 1 << 30
    assert not torch.cuda.is_initialized()


def test_skip_listed_shape_is_skipped():
    rec = dryrun.run_cell("dec_s", "long_500k", multi_pod=False)
    assert rec["status"] == "SKIP"
    assert rec["reason"] == get_arch("dec_s").skip_shapes["long_500k"]


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain
    version."""

    @property
    def device(self):
        return torch.device("xpu")


def _wrapper_calls():
    """(name, fn, CPU args) for every kernel wrapper."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 1, 4, 16, generator=g).bfloat16()
    kv = torch.randn(5, 32, 2, 16, generator=g).bfloat16()
    slots, pos = torch.tensor([4, 0, 2]), torch.tensor([3, 31, 9])
    qs, cents = torch.randn(4, 8, generator=g), torch.randn(10, 8, generator=g)
    luts = torch.rand(4, 3, 2, 16, generator=g)
    codes = torch.randint(0, 16, (2, 10, 6, 2), generator=g).to(torch.uint8)
    ids = torch.arange(120, dtype=torch.int32).view(2, 10, 6)
    lens = torch.randint(0, 7, (2, 10), generator=g).int()
    probe = torch.tensor([[1, 4, 7], [0, 2, 9], [3, 3, 5], [8, 6, 1]],
                         dtype=torch.int32)
    bl = luts[:, 0].contiguous()
    return [
        ("decode_attention", lambda q_, k_, v_, p_, s_: da.decode_attention(
            q_, k_, v_, p_, slots=s_, kv_len=32), (q, kv, kv, pos, slots)),
        ("ivf_index_scan", lambda *a: iv.ivf_index_scan(*a, 3),
         (qs, cents)),
        ("fused_scan", lambda *a: cs.fused_scan(*a, 5),
         (luts, codes, ids, lens, probe)),
        ("pq_adc_topk", lambda *a: pq.pq_adc_topk(*a, 4),
         (bl, codes[0, :4], lens[0, :4])),
        ("probed_adc_topk", lambda *a: pq.probed_adc_topk(*a, 4),
         (luts, codes[0], lens[0], probe)),
        ("pq_shared_scan", pq.pq_shared_scan, (bl, codes[0, 0])),
        ("approx_topk", lambda d: tk.approx_topk(d, 6, num_blocks=4),
         (torch.randn(3, 64, generator=g),)),
    ]


def test_wrappers_on_meta_give_the_plain_shapes_and_refuse_other_devices():
    for name, fn, args in _wrapper_calls():
        want = fn(*args)
        got = fn(*(a.to("meta") for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want), name
        for g_, w in zip(got, want):
            assert g_.device.type == "meta", name
            assert (g_.shape, g_.dtype) == (w.shape, w.dtype), name
        with pytest.raises(RuntimeError, match="no kernel for xpu"):
            fn(*(a.as_subclass(_Elsewhere) for a in args))
