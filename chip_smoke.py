"""Drive the PyTorch port's main path on one GPU and check its kernels.

    python3 chip_smoke.py

Phases (each prints its seconds and findings on its own line; any
failure raises, so the run exits non-zero):

  1. device: the card's name and power limit (nvidia-smi), torch, CUDA
     and nvcc versions; builds the CUDA kernels from src/repro_torch/csrc.
  2. set-up at full Dec-S width: seeded random weights, a seeded
     random-token corpus, kNN-LM keys from the LM itself, and an IVF-PQ
     datastore with the SYN-512 index shapes (dim 512, m=32, 8-bit codes,
     nprobe 32), scaled down in vector count (printed as cuts).
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the serve phase's shapes, then timed with CUDA events
     (L2 flushed before every run, the stream held while the run is
     enqueued, so host launch gaps are not timed) beside the plain
     version, a PyTorch library call where one computes the same
     function, and the least time the card could take for the work.
     The staged scan's kernels run at shard 0's staged shapes: adc_scan
     over the wave's 1024 (query, probe) entries, shared_scan of the
     wave's LUTs over the union of its probed lists, and the
     hierarchical top-k over the wave's staged ADC distance rows.
  4. serve: 8 requests x 4 rows through RalmEngine.from_config (wave
     decode, fused scan, async retrieval), 64 greedy tokens each, driven
     three times (tokens/s as median and range); before each run the
     kernels' launch counters are zeroed, and just after they must match
     the engine's wave and scan dispatch counts. Then serve.staged: the
     same traffic through a staged deployment (search_config(fused=False):
     one adc_scan launch per shard per flush), three runs alternating
     with three more fused runs, whose tokens must all equal the fused
     runs'. After the timed runs: one sampled request drawing from a
     CUDA generator, a profile of the fused and of the staged decode
     waves, and the accuracy witness: the same traffic with exact
     (flat L2) search over every key in place of the PQ index, with the
     rate at which each search's top-1 / top-K holds the true prefix's
     own key.

The last two lines are the kernel report and the device line, each one
JSON object. Without a GPU (or outside the repository) it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM float32, outside tensor cores
FULL = dict(n_docs=8192, doc_len=513, prompt_len=448, steps=64,
            requests=8, rows=4, nlist=256, nprobe=32, m=32, max_seq=512,
            train_stride=16, repeats=3)


def log(phase: str, t0: float, **kv) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.3f}s " +
          " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``flops`` float32 operations, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


class Timer:
    """Median of CUDA-event times over ``iters`` runs after a warm-up,
    with the L2 cache flushed (a 128 MB write) before every run. Before
    each run a spin kernel holds the stream for ``HOLD_CYCLES`` (~10 ms)
    while the host enqueues the start event, the run and the end event,
    so the time is the device's, without the host's launch gaps (a
    short kernel's wrapper takes tens of microseconds of Python)."""

    HOLD_CYCLES = 20_000_000

    def __init__(self, torch, iters: int = 25, warmup: int = 3):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


# ---------------------------------------------------------------------------
# set-up: weights, corpus, datastore
# ---------------------------------------------------------------------------

def setup(dev, sizes):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DatastoreBuilder

    t0 = time.perf_counter()
    arch = get_arch("dec_s")
    cfg = arch.model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    n_params = sum(t.numel() for c in params["classes"].values()
                   for t in c.values()) + params["embed"].numel() + \
        params["final_norm"].numel()
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, cfg.vocab_size,
                          size=(sizes["n_docs"], sizes["doc_len"]),
                          dtype=np.int32)
    log("setup.params", t0, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=n_params,
        dtype=cfg.dtype)
    builder = DatastoreBuilder(dim=cfg.d_model, nlist=sizes["nlist"],
                               m=sizes["m"], list_cap=None, device=str(dev))
    t1 = time.perf_counter()
    keys, nxt = builder.corpus_keys(params, cfg, corpus)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    log("setup.corpus_keys", t1, keys=tuple(keys.shape))
    t2 = time.perf_counter()
    ds = builder.build(keys, payload_tokens=nxt,
                       train_vectors=keys[::sizes["train_stride"]])
    lens = torch.stack([s.list_len for s in ds.shards]).float()
    log("setup.datastore", t2, vectors=ds.num_vectors, nlist=sizes["nlist"],
        m=ds.index_cfg.m, shards=ds.num_shards,
        list_cap=ds.index_cfg.list_cap,
        mean_list_slice=round(float(lens.mean()), 1),
        max_list_slice=int(lens.max()),
        train_vectors=int(keys[::sizes["train_stride"]].shape[0]))
    print(f"[cuts] vectors {ds.num_vectors} vs SYN-512's 1e9 "
          f"({1e9 / ds.num_vectors:.0f}x fewer); nlist {sizes['nlist']} "
          f"vs the paper's 32768; quantizers trained on every "
          f"{sizes['train_stride']}th key; model depth not cut", flush=True)
    return arch, cfg, params, corpus, keys, ds


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def kernel_decode_attn(torch, dev, timer, cfg, sizes, report):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import ops as da
    from repro_torch.kernels.decode_attn.ref import decode_validity

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(1)
    W = sizes["requests"] * sizes["rows"]
    P, S = W + 1, sizes["max_seq"]      # the serve pool: W rows + scratch

    def case(H, KV, D, S, window, ring, pos_lo, pos_hi, kv_len):
        k = torch.randn((P, S, KV, D), generator=g, device=dev
                        ).to(torch.bfloat16)
        v = torch.randn((P, S, KV, D), generator=g, device=dev
                        ).to(torch.bfloat16)
        q = torch.randn((W, 1, H, D), generator=g, device=dev
                        ).to(torch.bfloat16)
        slots = torch.randperm(P - 1, generator=g, device=dev)[:W].int()
        pos = torch.randint(pos_lo, pos_hi + 1, (W,), generator=g,
                            device=dev).int()
        args = (q, k, v, pos)
        kw = dict(window=window, ring=ring, slots=slots, kv_len=kv_len)
        out = da.decode_attention(*args, **kw)
        torch.cuda.synchronize()
        plain = da._gather_rows(q, k, v, slots, kv_len, ring)
        ref = da.ref_decode_attention(q, *plain, pos, window=window, ring=ring)
        exact = da.ref_decode_attention(q.float(), plain[0].float(),
                                        plain[1].float(), pos, window=window,
                                        ring=ring)
        err = (out.float() - ref.float()).abs().max().item()
        err32 = (out.float() - exact).abs().max().item()
        scale = ref.float().abs().max().item()
        # tolerance: the plain version rounds scores and softmax weights
        # to bf16 (2^-9 relative each, amplified by |score| in exp), the
        # kernel stays f32 — 2^-5 of the output range covers it; against
        # the f32 oracle only the kernel's final bf16 rounding remains
        tol = 2 ** -5 * scale + 1e-3
        tol32 = 2 ** -8 * scale + 1e-5
        if not (err <= tol and err32 <= tol32):
            raise AssertionError(
                f"decode_attn H={H} KV={KV} D={D} S={S} window={window} "
                f"ring={ring}: err {err} (tol {tol}), vs f32 {err32} "
                f"(tol {tol32})")
        return q, k, v, slots, pos, kw, plain, err, err32, tol

    # the serve phase's shape: Dec-S heads, pool of W+1 rows, ragged
    # positions over the generation window, kv_len = the pool's max_seq
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v, slots, pos, kw, plain, err, err32, tol = case(
        H, KV, D, S, 0, False, sizes["prompt_len"], S - 1, S)
    extra = [case(8, 4, 128, S, 0, False, 1, S - 1, S),            # G=2
             case(H, KV, D, 64, 64, True, 0, 700, None),           # ring
             case(H, KV, D, S, 48, False, 100, S - 1, S)]          # window
    ms = timer(lambda: da.decode_attention(q, k, v, pos, **kw))
    plain_ms = timer(lambda: da.ref_decode_attention(
        q, *da._gather_rows(q, k, v, slots, kw["kv_len"], False), pos))
    valid = decode_validity(pos, S, 0, False)
    mask = valid[:, None, None, :]
    qs = q.transpose(1, 2)                       # [W, H, 1, D]
    ks, vs = plain[0].transpose(1, 2), plain[1].transpose(1, 2)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    n_valid = int(valid.sum())
    nbytes = 2 * n_valid * KV * D * 2 + 2 * q.numel() * 2 + W * 8
    flops = 4 * n_valid * H * D
    bound_ms, bound_by = bound(nbytes, flops)
    report["decode_attn"] = dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/kernel.py:109",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms)
    log("kernel.decode_attn", t0, shape=f"W={W},H={H},KV={KV},D={D},"
        f"S={S},P={P}", max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
        err_vs_f32=f"{err32:.3e}",
        extra_cases_err=[f"{c[7]:.3e}" for c in extra],
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        sdpa_ms=f"{lib_ms:.4f}", bound_ms=f"{bound_ms:.4f}")


def kernel_ivf_scan(torch, dev, timer, ds, queries, sizes, report):
    from repro_torch.core.kmeans import _pairwise_sq_l2
    from repro_torch.kernels.ivf_scan import ops as iv

    t0 = time.perf_counter()
    cents = ds.params.coarse_centroids
    nprobe = sizes["nprobe"]
    dk, ik = iv.ivf_index_scan(queries, cents, nprobe)
    dp, ip = iv.ref_ivf_scan(queries, cents, nprobe)
    torch.cuda.synchronize()
    full = _pairwise_sq_l2(queries, cents)
    mism = ik != ip
    # ids may differ only where the two candidates' distances tie within
    # 1e-5 relative (the kernel's FMA order differs from the GEMM's)
    dk_of = torch.gather(full, 1, ik.long())
    dp_of = torch.gather(full, 1, ip.long())
    near = (dk_of - dp_of).abs() <= 1e-5 * dp_of.abs()
    if bool((mism & ~near).any()):
        raise AssertionError(f"ivf_scan ids differ beyond near-ties: "
                             f"{int((mism & ~near).sum())}")
    rel = ((dk - dp).abs() / dp.abs().clamp(min=1e-30)).max().item()
    if rel > 1e-5:
        raise AssertionError(f"ivf_scan distances differ: rel {rel}")
    err = (dk - dp).abs().max().item()
    ms = timer(lambda: iv.ivf_index_scan(queries, cents, nprobe))
    plain_ms = timer(lambda: iv.ref_ivf_scan(queries, cents, nprobe))
    nq, D = queries.shape
    nlist = cents.shape[0]
    nbytes = (nlist * D + nq * D) * 4 + nq * nprobe * 8
    flops = 2 * nq * nlist * D + 3 * nq * nlist
    bound_ms, bound_by = bound(nbytes, flops)
    report["ivf_scan"] = dict(
        name="ivf_scan", route="cuda", source="src/repro_torch/csrc/ivf_scan.cu",
        replaces="src/repro/kernels/ivf_scan/kernel.py:51",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    log("kernel.ivf_scan", t0, shape=f"nq={nq},nlist={nlist},D={D},"
        f"nprobe={nprobe}", id_mismatch_near_ties=int(mism.sum()),
        max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}")
    return ik


def kernel_fused_scan(torch, dev, timer, ds, queries, probe_ids, kk, report):
    from repro_torch.core import ivfpq
    from repro_torch.core.chamvs import stack_shards
    from repro_torch.kernels.chamvs_scan import ops as cs

    t0 = time.perf_counter()
    st = stack_shards(ds.shards)
    luts = ivfpq.compute_luts(ds.params, queries, probe_ids, ds.index_cfg)
    args = (luts, st.codes, st.ids, st.list_len, probe_ids, kk)
    dk, ik = cs.fused_scan(*args)
    p = probe_ids.long()
    dp, ip = cs.ref_chamvs_scan(luts, st.codes[:, p], st.ids[:, p],
                                st.list_len[:, p], kk)
    torch.cuda.synchronize()
    if not torch.equal(ik, ip):
        raise AssertionError(f"fused_scan ids differ: "
                             f"{int((ik != ip).sum())} of {ik.numel()}")
    fin = torch.isfinite(dp)
    rel = ((dk - dp).abs()[fin] / dp.abs()[fin].clamp(min=1e-30)).max().item()
    if rel > 1e-5 or not torch.equal(torch.isfinite(dk), fin):
        raise AssertionError(f"fused_scan distances differ: rel {rel}")
    err = (dk - dp)[fin].abs().max().item()
    ms = timer(lambda: cs.fused_scan(*args))
    plain_ms = timer(lambda: cs.ref_chamvs_scan(
        luts, st.codes[:, p], st.ids[:, p], st.list_len[:, p], kk))
    S = st.codes.shape[0]
    nq, nprobe = probe_ids.shape
    m, ksub = luts.shape[2], luts.shape[3]
    lens = st.list_len[:, p].double()                       # [S, nq, np]
    rows = float(lens.sum())
    # codes of every scanned row, the distinct LUTs (one per query when
    # the probe axis is a stride-0 view), the outputs, and the global ids
    # of the kk winners: an id is needed only for a row that wins
    n_luts = nq * (1 if luts.stride(1) == 0 else nprobe)
    nbytes = rows * m + n_luts * m * ksub * 4 + S * nq * kk * (8 + 4)
    flops = rows * m
    bound_ms, bound_by = bound(nbytes, flops)
    report["fused_scan"] = dict(
        name="fused_scan", route="cuda",
        source="src/repro_torch/csrc/chamvs_scan.cu",
        replaces="src/repro/kernels/chamvs_scan/kernel.py:93",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    log("kernel.fused_scan", t0, shape=f"S={S},nq={nq},nprobe={nprobe},"
        f"cap={st.codes.shape[2]},m={m},kk={kk}",
        mean_len=f"{float(lens.mean()):.1f}", ids_equal=True,
        max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}")


def kernel_adc_scan(torch, dev, timer, ds, queries, probe_ids, kk, report):
    """adc_scan at the staged serve shape of shard 0; returns the wave's
    staged ADC distance rows [nq, nprobe * cap] (+inf past each list's
    length) for the hierarchical top-k phase."""
    from repro_torch.core import ivfpq
    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.kernels.pq_adc import ref as pq_ref

    t0 = time.perf_counter()
    # what the staged scan hands pq_adc_topk for shard 0: one entry per
    # (query, probe), the gathered probed lists' codes and lengths
    icfg, shard = ds.index_cfg, ds.shards[0]
    nq, nprobe = probe_ids.shape
    B, cap, m, ksub = nq * nprobe, icfg.list_cap, icfg.m, icfg.ksub
    p = probe_ids.long()
    luts = ivfpq.compute_luts(ds.params, queries, probe_ids, icfg
                              ).reshape(B, m, ksub)
    codes = shard.codes[p].reshape(B, cap, m)
    lens = shard.list_len[p].reshape(B)
    k = min(kk, cap)
    dk, ik = pq.pq_adc_topk(luts, codes, lens, k)
    dp, ip = pq_ref.ref_pq_adc_topk(luts, codes, lens, k)
    torch.cuda.synchronize()
    if not torch.equal(ik, ip):
        raise AssertionError(f"adc_scan ids differ: "
                             f"{int((ik != ip).sum())} of {ik.numel()}")
    if not torch.equal(dk, dp):
        raise AssertionError("adc_scan distances differ from the plain "
                             "version's (both sum in index order)")
    fin = torch.isfinite(dp)
    err = (dk - dp)[fin].abs().max().item()
    ms = timer(lambda: pq.pq_adc_topk(luts, codes, lens, k))
    plain_ms = timer(lambda: pq_ref.ref_pq_adc_topk(luts, codes, lens,
                                                            k))
    rows = float(lens.double().sum())
    # codes of the valid rows, one LUT per entry (the staged scan's
    # input), lens, and the (dist, row) outputs
    nbytes = rows * m + B * m * ksub * 4 + B * 4 + B * k * 8
    bound_ms, bound_by = bound(nbytes, rows * m)
    report["adc_scan"] = dict(
        name="adc_scan", route="cuda", source="src/repro_torch/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc/kernel.py:101",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    log("kernel.adc_scan", t0, shape=f"B={B},n={cap},m={m},ksub={ksub},k={k}",
        mean_len=f"{rows / B:.1f}", ids_equal=True, dists_bit_equal=True,
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}")
    d = pq_ref.ref_adc_batch(luts, codes)
    valid = torch.arange(cap, device=dev)[None, :] < lens[:, None]
    return torch.where(valid, d, torch.full_like(d, float("inf"))
                       ).reshape(nq, -1)


def kernel_shared_scan(torch, dev, timer, ds, queries, probe_ids, report):
    """shared_scan: the wave's non-residual LUTs against the valid code
    rows of the union of the lists the wave probes in shard 0."""
    import torch.nn.functional as F
    from repro_torch.core import ivfpq
    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.kernels.pq_adc import ref as pq_ref

    t0 = time.perf_counter()
    icfg, shard = ds.index_cfg, ds.shards[0]
    if icfg.residual:
        raise AssertionError("shared_scan needs a non-residual index")
    luts = ivfpq.compute_luts(ds.params, queries, probe_ids, icfg
                              )[:, 0].contiguous()           # [q, m, ksub]
    q, m, ksub = luts.shape
    lists = torch.unique(probe_ids.long())
    valid = (torch.arange(icfg.list_cap, device=dev)[None, :]
             < shard.list_len[lists][:, None])
    codes = shard.codes[lists][valid].contiguous()           # [n, m]
    n = codes.shape[0]
    out = pq.pq_shared_scan(luts, codes)
    want = pq_ref.ref_shared_scan(luts, codes).T
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("shared_scan distances differ from the plain "
                             "version's (both sum in index order)")
    err = (out - want).abs().max().item()
    # the library yardstick: one embedding_bag call computes the same
    # sums (in its own order) from codes offset into a stacked table
    weight = luts.reshape(q, m * ksub).T.contiguous()        # [m*ksub, q]
    idx = codes.long() + torch.arange(m, device=dev) * ksub
    lib_err = (F.embedding_bag(idx, weight, mode="sum") - out).abs().max(
    ).item()
    ms = timer(lambda: pq.pq_shared_scan(luts, codes))
    plain_ms = timer(lambda: pq_ref.ref_shared_scan(luts, codes))
    lib_ms = timer(lambda: F.embedding_bag(idx, weight, mode="sum"))
    nbytes = n * m + q * m * ksub * 4 + n * q * 4
    bound_ms, bound_by = bound(nbytes, n * q * m)
    report["shared_scan"] = dict(
        name="shared_scan", route="cuda",
        source="src/repro_torch/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc/kernel.py:158",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms)
    log("kernel.shared_scan", t0, shape=f"q={q},n={n},m={m},ksub={ksub}",
        lists=int(lists.numel()), bit_equal=True, max_abs_err=f"{err:.3e}",
        embedding_bag_err=f"{lib_err:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", embedding_bag_ms=f"{lib_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}")


def kernel_hierarchical_topk(torch, dev, timer, d, k, num_blocks, report):
    """approx_topk over the wave's staged ADC distance rows; also the
    share of rows on which the approximate result is the exact one."""
    from repro_torch.core.approx_topk_math import truncated_queue_len
    from repro_torch.kernels.topk import ops as tk
    from repro_torch.kernels.topk import ref as tk_ref

    t0 = time.perf_counter()
    B, n = d.shape
    kp = truncated_queue_len(k, num_blocks)
    dk, ik = tk.approx_topk(d, k, num_blocks=num_blocks)
    dp, ip = tk_ref.ref_hierarchical_topk(d, k, num_blocks, kp)
    de, ie = tk_ref.ref_exact_topk(d, k)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
        raise AssertionError(f"hierarchical_topk differs from the plain "
                             f"version: {int((ik != ip).sum())} ids")
    fin = torch.isfinite(dp)
    err = (dk - dp)[fin].abs().max().item() if bool(fin.any()) else 0.0
    exact_rows = ((ik == ie) & (dk == de)).all(dim=1).float().mean().item()
    ms = timer(lambda: tk.approx_topk(d, k, num_blocks=num_blocks))
    plain_ms = timer(lambda: tk_ref.ref_hierarchical_topk(d, k, num_blocks,
                                                             kp))
    lib_ms = timer(lambda: torch.topk(d, k, dim=1, largest=False))
    nbytes = B * n * 4 + B * k * 8
    bound_ms, bound_by = bound(nbytes, B * n)
    report["hierarchical_topk"] = dict(
        name="hierarchical_topk", route="cuda",
        source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk/kernel.py:34",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms)
    log("kernel.hierarchical_topk", t0, shape=f"B={B},n={n},k={k},"
        f"num_blocks={num_blocks},k_prime={kp}",
        inf_share=f"{float(torch.isinf(d).float().mean()):.3f}",
        equal_to_plain=True, rows_equal_to_exact=f"{exact_rows:.4f}",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        torch_topk_ms=f"{lib_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}")


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def checked_engine(torch, dev, arch, cfg, params, ds, sizes, fused):
    """The serve phase's engine through RalmEngine.from_config (async
    retrieval, fused or staged scan), wrapped so that finiteness and
    id-range checks accumulate on the device (no syncs); ``check()``
    raises if any of them failed."""
    from repro_torch.serve import EngineConfig, RalmEngine

    search_cfg = ds.search_config(nprobe=sizes["nprobe"], k=arch.rag.k,
                                  fused=fused)
    eng = RalmEngine.from_config(
        EngineConfig(model=cfg, rag=arch.rag, max_seq=sizes["max_seq"],
                     async_retrieval=True, retrieval_measure=False),
        params, ds, search_cfg, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    n_vec = ds.num_vectors
    backend, retriever = eng.backend, eng.retriever
    prefill, decode_wave, resolve = (backend.prefill, backend.decode_wave,
                                     retriever.resolve)

    def checked_prefill(*a, **k):
        nonlocal ok
        caches, logits, hidden = prefill(*a, **k)
        ok = ok & torch.isfinite(logits).all()
        return caches, logits, hidden

    def checked_decode(*a, **k):
        nonlocal ok
        logits, caches, hidden = decode_wave(*a, **k)
        ok = ok & torch.isfinite(logits).all()
        return logits, caches, hidden

    def checked_resolve(ids, kind="tokens"):
        nonlocal ok
        ok = ok & ((ids == -1) | ((ids >= 0) & (ids < n_vec))).all()
        return resolve(ids, kind)

    def check():
        if not bool(ok):
            raise AssertionError("non-finite logits or out-of-range ids")

    backend.prefill, backend.decode_wave = checked_prefill, checked_decode
    retriever.resolve = checked_resolve
    return eng, search_cfg, check


def drive(torch, eng, cfg, prompts, truth, steps, label):
    """One run of the traffic, with the launch counters zeroed just
    before and read just after. Every kernel must have launched exactly
    as the engine dispatched: decode attention once per layer per wave,
    the IVF probe once per search flush, and the scan kernel of the
    deployment (fused scan, or adc_scan per shard) once per scan
    dispatch; no other kernel."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.serve import RalmRequest

    stats = eng.retriever.service.stats
    pipeline = eng.retriever.service.pipeline
    waves0, scans0 = eng.decode_dispatches, stats.scan_dispatches
    flushes0, batched0 = stats.num_batches, stats.batched_rows

    def pool_rows():
        st = eng.pool.stats if eng.pool is not None else None
        return (st.wave_rows, st.waves) if st is not None else (0, 0)

    rows0 = pool_rows()
    torch.cuda.synchronize()
    _build.reset_launches()
    t1 = time.perf_counter()
    rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=steps))
            for p in prompts]
    done = eng.step()                       # admission + prefill + step 0
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    done += eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {n: k.launches for n, k in _build.kernels().items()}
    waves = eng.decode_dispatches - waves0
    scans = stats.scan_dispatches - scans0
    flushes = stats.num_batches - flushes0
    rows1 = pool_rows()
    wave_rows = (rows1[0] - rows0[0]) / max(rows1[1] - rows0[1], 1)
    by_id = {r.request_id: r.tokens for r in done}
    out = np.stack([by_id[r] for r in rids])            # [R, B, T0 + steps]
    R, B = len(prompts), prompts[0].shape[0]
    gen = out[:, :, prompts[0].shape[1]:].reshape(R * B, steps)
    acc = float((gen == truth).mean())
    tokens = R * B * steps
    log(label, t1, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{tokens / wall:.1f}", generated_tokens=tokens,
        first_step_s=f"{t_first:.3f}",
        decode_ms_per_wave=f"{(wall - t_first) / max(waves, 1) * 1e3:.2f}",
        decode_waves=waves, mean_wave_rows=f"{wave_rows:.2f}",
        search_flushes=flushes, scan_dispatches=scans,
        coalescing=f"{(stats.batched_rows - batched0) / max(flushes, 1):.1f}",
        continuation_accuracy=f"{acc:.4f}", launches=launches)
    scan_kernel = ("chamvs_scan_launch" if pipeline.cfg.fused
                   else "adc_scan_launch")
    want = dict.fromkeys(launches, 0)
    want.update({"decode_attn_launch": cfg.n_layers * waves,
                 "ivf_scan_launch": flushes, scan_kernel: scans})
    if scans != pipeline.scan_dispatches * flushes or flushes <= 0 or \
            waves <= 0 or launches != want:
        raise AssertionError(f"launches {launches} != expected {want} "
                             f"({flushes} flushes, {scans} scans)")
    return dict(tps=tokens / wall, acc=acc, gen=gen, launches=launches,
                ms_wave=(wall - t_first) / waves * 1e3)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def serve(torch, dev, arch, cfg, params, corpus, ds, sizes):
    """The fused deployment, driven ``repeats`` times."""
    import numpy as np

    t0 = time.perf_counter()
    eng, search_cfg, check = checked_engine(torch, dev, arch, cfg, params,
                                            ds, sizes, fused=True)
    R, B, T0 = sizes["requests"], sizes["rows"], sizes["prompt_len"]
    steps = sizes["steps"]
    prompts = [corpus[r * B:(r + 1) * B, :T0] for r in range(R)]
    truth = corpus[:R * B, T0:T0 + steps]
    log("serve.setup", t0, requests=R, rows_per_request=B, prompt_len=T0,
        steps=steps, k=arch.rag.k, nprobe=search_cfg.nprobe,
        kprime=search_cfg.k_prime(ds.num_shards), repeats=sizes["repeats"])
    runs = [drive(torch, eng, cfg, prompts, truth, steps, "serve.run")
            for _ in range(sizes["repeats"])]
    check()
    tps = sorted(r["tps"] for r in runs)
    ms_wave = sorted(r["ms_wave"] for r in runs)
    log("serve.summary", t0, tokens_per_s_median=f"{median(tps):.1f}",
        tokens_per_s_range=f"{tps[0]:.1f}-{tps[-1]:.1f}",
        decode_ms_per_wave_median=f"{median(ms_wave):.2f}",
        decode_ms_per_wave_range=f"{ms_wave[0]:.2f}-{ms_wave[-1]:.2f}",
        continuation_accuracy=[f"{r['acc']:.4f}" for r in runs],
        tokens_equal_across_runs=all(np.array_equal(r["gen"], runs[0]["gen"])
                                     for r in runs))
    return eng, prompts, truth, runs


def serve_staged(torch, dev, arch, cfg, params, ds, sizes, prompts, truth,
                 fused_eng):
    """The same traffic through a staged deployment
    (``search_config(fused=False)``): the IVF probe, then per shard the
    gather of the probed lists and one adc_scan launch. Same ids and
    bit-identical distances as the fused scan, so the tokens must equal
    the fused runs'. Staged and fused runs alternate, ``repeats`` each,
    so that the two rates share the call's host. Returns the staged
    engine and its first run's launch counts."""
    import numpy as np

    t0 = time.perf_counter()
    eng, _, check = checked_engine(torch, dev, arch, cfg, params, ds, sizes,
                                   fused=False)
    staged, fused = [], []
    for _ in range(sizes["repeats"]):
        staged.append(drive(torch, eng, cfg, prompts, truth, sizes["steps"],
                            "serve.staged"))
        fused.append(drive(torch, fused_eng, cfg, prompts, truth,
                           sizes["steps"], "serve.run"))
    check()
    if not all(np.array_equal(r["gen"], f["gen"])
               for r in staged for f in fused):
        raise AssertionError("staged tokens differ from the fused runs'")
    tps = sorted(r["tps"] for r in staged)
    ms_wave = sorted(r["ms_wave"] for r in staged)
    log("serve.staged_summary", t0, tokens_equal_to_fused=True,
        shards=ds.num_shards, tokens_per_s_median=f"{median(tps):.1f}",
        tokens_per_s_range=f"{tps[0]:.1f}-{tps[-1]:.1f}",
        decode_ms_per_wave_median=f"{median(ms_wave):.2f}",
        decode_ms_per_wave_range=f"{ms_wave[0]:.2f}-{ms_wave[-1]:.2f}",
        fused_tokens_per_s_median=f"{median([r['tps'] for r in fused]):.1f}",
        fused_decode_ms_per_wave_median=(
            f"{median([r['ms_wave'] for r in fused]):.2f}"))
    return eng, staged[0]["launches"]


def sampled_request(torch, eng, prompt, vocab, steps):
    """One request drawing from a CUDA generator: the draw stays on the
    card. Timed beside the same request decoded greedily; two draws from
    the same seed must give the same tokens."""
    import numpy as np
    from repro_torch.serve import RalmRequest

    t0 = time.perf_counter()
    outs, ms = [], []
    for greedy in (True, False, False):
        rng = None if greedy else \
            torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.submit(RalmRequest(prompt=torch.from_numpy(prompt), steps=steps,
                               greedy=greedy, rng=rng))
        (resp,) = eng.run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) / steps * 1e3)
        outs.append(np.asarray(resp.tokens)[:, prompt.shape[1]:])
    if not (np.array_equal(outs[1], outs[2]) and
            ((outs[1] >= 0) & (outs[1] < vocab)).all()):
        raise AssertionError("sampled tokens differ between equal seeds or "
                             "fall out of the vocabulary")
    log("serve.sampled", t0, rows=prompt.shape[0], steps=steps,
        greedy_ms_per_step=f"{ms[0]:.2f}", sampled_ms_per_step=f"{ms[2]:.2f}",
        same_seed_same_tokens=True)


class ExactRetriever:
    """Flat exact L2 search over every key, for the accuracy witness: no
    IVF probe and no product quantization between the query and its
    neighbours. (torch.topk's order among equal distances does not matter
    for a witness.)"""

    def __init__(self, torch, keys, payload, k):
        self.torch, self.keys, self.payload, self.k = torch, keys, payload, k
        self.norms = (keys * keys).sum(1)

    def search(self, queries):
        q = queries.float()
        d = (q * q).sum(1, keepdim=True) - 2.0 * (q @ self.keys.T) + \
            self.norms
        dist, ids = self.torch.topk(d, self.k, dim=1, largest=False)
        return dist, ids.int()

    def resolve(self, ids, kind="tokens"):
        return self.payload[ids.long()]


def accuracy_witness(torch, eng, arch, cfg, keys, ds, corpus, prompts,
                     sizes):
    """Is the accuracy short of 1 because of the PQ index? The serve
    traffic again, once through the PQ engine and once with exact search
    over the same keys. Row r's search at step s should find key
    r * (doc_len - 1) + T0 - 1 + s (the hidden state of the very prefix
    it continues) while the generated prefix still equals the corpus."""
    import numpy as np
    from repro_torch.serve import RalmEngine, RalmRequest

    t0 = time.perf_counter()
    R, B, T0 = sizes["requests"], sizes["rows"], sizes["prompt_len"]
    steps, per_doc = sizes["steps"], sizes["doc_len"] - 1
    truth = corpus[:R * B, T0:T0 + steps]
    true_id = (np.arange(R * B)[:, None] * per_doc + T0 - 1 +
               np.arange(steps)[None, :])                    # [R*B, steps]
    exact = RalmEngine.monolithic(
        eng.backend.params, cfg, arch.rag,
        retriever=ExactRetriever(torch, keys, ds.payload_tokens, arch.rag.k),
        max_seq=sizes["max_seq"])
    found = {}
    for name, e in (("pq", eng), ("exact", exact)):
        traces = [[] for _ in prompts]
        rids = [e.submit(RalmRequest(prompt=torch.from_numpy(p), steps=steps,
                                     trace=tr))
                for p, tr in zip(prompts, traces)]
        by_id = {r.request_id: r.tokens for r in e.run()}
        gen = np.stack([by_id[r] for r in rids])[:, :, T0:].reshape(
            R * B, steps)
        ids = np.stack([np.stack([t["ids"] for t in sorted(
            tr, key=lambda t: t["step"])], 1) for tr in traces]
                       ).reshape(R * B, steps, -1)           # [R*B, steps, K]
        match = gen == truth
        on_truth = np.concatenate([np.ones((R * B, 1), bool),
                                   np.cumprod(match, 1)[:, :-1] > 0], 1)
        top1 = ids[:, :, 0] == true_id
        in_k = (ids == true_id[:, :, None]).any(-1)
        found[name] = dict(
            acc=f"{match.mean():.4f}", on_truth_steps=int(on_truth.sum()),
            true_key_top1=f"{top1[on_truth].mean():.4f}",
            true_key_in_topk=f"{in_k[on_truth].mean():.4f}")
    log("serve.witness", t0, k=arch.rag.k, pq=found["pq"],
        exact=found["exact"])
    if float(found["exact"]["acc"]) <= 0.0:
        raise AssertionError("exact-search witness generated nothing right")


def profile_waves(torch, eng, prompts, steps, label="serve.profile"):
    """Where the decode time goes: the same traffic, admitted and
    prefilled outside the window, then ``steps - 1`` decode waves under
    torch.profiler. Device busy share = the summed time of the events
    that ran on the card (kernels, copies) over the window's wall time."""
    from repro_torch.serve import RalmRequest

    for p in prompts:
        eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=steps))
    eng.step()                              # admission + prefill + step 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0)), e.count,
                   e.key) for e in dev)[::-1]
    busy_us = sum(r[0] for r in rows)
    log(label, t0, decode_waves=steps - 1,
        wall_ms=f"{wall * 1e3:.1f}", device_busy_ms=f"{busy_us / 1e3:.1f}",
        device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        device_events=len(rows))
    for us, count, key in rows[:12]:
        print(f"  device {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}",
              flush=True)


def run_phases(torch, dev, sizes):
    """Set-up, the kernel phases and the serve phases on ``dev`` at
    ``sizes``; returns the kernel report rows."""
    arch, cfg, params, corpus, keys, ds = setup(dev, sizes)

    timer = Timer(torch)
    report = {}
    W = sizes["requests"] * sizes["rows"]
    g = torch.Generator(device=dev).manual_seed(2)
    pick = torch.randint(0, keys.shape[0], (W,), generator=g, device=dev)
    queries = (keys[pick] + 0.01 * torch.randn(
        (W, keys.shape[1]), generator=g, device=dev)).contiguous()
    kernel_decode_attn(torch, dev, timer, cfg, sizes, report)
    probe_ids = kernel_ivf_scan(torch, dev, timer, ds, queries, sizes, report)
    kk = ds.search_config(nprobe=sizes["nprobe"],
                          k=arch.rag.k).k_prime(ds.num_shards)
    kernel_fused_scan(torch, dev, timer, ds, queries, probe_ids, kk, report)
    staged_d = kernel_adc_scan(torch, dev, timer, ds, queries, probe_ids, kk,
                               report)
    kernel_shared_scan(torch, dev, timer, ds, queries, probe_ids, report)
    kernel_hierarchical_topk(torch, dev, timer, staged_d, arch.rag.k, 16,
                             report)
    del staged_d
    torch.cuda.empty_cache()

    eng, prompts, truth, runs = serve(torch, dev, arch, cfg, params, corpus,
                                      ds, sizes)
    staged_eng, staged = serve_staged(torch, dev, arch, cfg, params, ds,
                                      sizes, prompts, truth, eng)
    # after every timed serve run: a profiled window leaves the profiler's
    # hooks behind, which slows the host side of later waves
    sampled_request(torch, eng, prompts[0], cfg.vocab_size, steps=16)
    profile_waves(torch, eng, prompts, steps=16)
    profile_waves(torch, staged_eng, prompts, steps=16,
                  label="serve.staged_profile")
    del staged_eng
    torch.cuda.empty_cache()
    accuracy_witness(torch, eng, arch, cfg, keys, ds, corpus, prompts, sizes)
    # launches: each kernel's count in one run of the serve path that
    # reaches it; shared_scan and hierarchical_topk have no serving
    # caller in either package, only their entry points
    fused = runs[0]["launches"]
    for name, sym, path, counts in (
            ("decode_attn", "decode_attn_launch", "serve.run", fused),
            ("ivf_scan", "ivf_scan_launch", "serve.run", fused),
            ("fused_scan", "chamvs_scan_launch", "serve.run", fused),
            ("adc_scan", "adc_scan_launch", "serve.staged", staged),
            ("shared_scan", "shared_scan_launch",
             "no serve path (entry point pq_shared_scan)", fused),
            ("hierarchical_topk", "hierarchical_topk_launch",
             "no serve path (entry point approx_topk)", fused)):
        report[name]["launches"] = counts[sym]
        report[name]["launches_in"] = path
    return [report[k] for k in ("decode_attn", "ivf_scan", "fused_scan",
                                "adc_scan", "shared_scan",
                                "hierarchical_topk")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script measures the GPU path and has no CPU fallback")
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    ptx = [ln.strip() for ln in _build.build_log().splitlines()
           if "registers" in ln or "spill" in ln]
    log("device", t0, torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc.strip().splitlines()[-1] if nvcc else "?",
        kernels_built=len(_build._sources()))
    for ln in ptx:
        print(f"  ptxas {ln}", flush=True)

    kernels = run_phases(torch, dev, dict(FULL))
    log("total", t_all,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
