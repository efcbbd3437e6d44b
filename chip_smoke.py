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
     (L2 flushed before every run) beside the plain version, a
     PyTorch library call where one computes the same function, and the
     least time the card could take for the work.
  4. serve: 8 requests x 4 rows through RalmEngine.from_config (wave
     decode, fused scan, async retrieval), 64 greedy tokens each, driven
     three times (tokens/s as median and range); before each run the
     kernels' launch counters are zeroed, and just after they must match
     the engine's wave and scan dispatch counts. Then: a profile of the
     decode waves, one sampled request drawing from a CUDA generator, and
     the accuracy witness: the same traffic with exact (flat L2) search
     over every key in place of the PQ index, with the rate at which
     each search's top-1 / top-K holds the true prefix's own key.

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


class Timer:
    """Median of CUDA-event times over ``iters`` runs after a warm-up,
    with the L2 cache flushed (a 128 MB write) before every run."""

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
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    report["decode_attn"] = dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/kernel.py:109",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
        else "operations", library_ms=lib_ms)
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
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    report["ivf_scan"] = dict(
        name="ivf_scan", route="cuda", source="src/repro_torch/csrc/ivf_scan.cu",
        replaces="src/repro/kernels/ivf_scan/kernel.py:51",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
        else "operations", library_ms=None)
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
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    report["fused_scan"] = dict(
        name="fused_scan", route="cuda",
        source="src/repro_torch/csrc/chamvs_scan.cu",
        replaces="src/repro/kernels/chamvs_scan/kernel.py:93",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
        else "operations", library_ms=None)
    log("kernel.fused_scan", t0, shape=f"S={S},nq={nq},nprobe={nprobe},"
        f"cap={st.codes.shape[2]},m={m},kk={kk}",
        mean_len=f"{float(lens.mean()):.1f}", ids_equal=True,
        max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}")


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def serve(torch, dev, arch, cfg, params, corpus, ds, sizes):
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.serve import EngineConfig, RalmEngine, RalmRequest

    t0 = time.perf_counter()
    search_cfg = ds.search_config(nprobe=sizes["nprobe"], k=arch.rag.k)
    eng = RalmEngine.from_config(
        EngineConfig(model=cfg, rag=arch.rag, max_seq=sizes["max_seq"],
                     async_retrieval=True, retrieval_measure=False),
        params, ds, search_cfg, device=dev)
    # finiteness / id-range checks accumulate on the device (no syncs)
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

    backend.prefill, backend.decode_wave = checked_prefill, checked_decode
    retriever.resolve = checked_resolve
    R, B, T0 = sizes["requests"], sizes["rows"], sizes["prompt_len"]
    steps = sizes["steps"]
    prompts = [corpus[r * B:(r + 1) * B, :T0] for r in range(R)]
    truth = corpus[:R * B, T0:T0 + steps]
    stats = eng.retriever.service.stats
    log("serve.setup", t0, requests=R, rows_per_request=B, prompt_len=T0,
        steps=steps, k=arch.rag.k, nprobe=search_cfg.nprobe,
        kprime=search_cfg.k_prime(ds.num_shards), repeats=sizes["repeats"])

    def drive():
        """One run of the traffic, with the launch counters zeroed just
        before and read just after."""
        waves0, scans0 = eng.decode_dispatches, stats.scan_dispatches
        torch.cuda.synchronize()
        _build.reset_launches()
        t1 = time.perf_counter()
        rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p),
                                       steps=steps)) for p in prompts]
        done = eng.step()                   # admission + prefill + step 0
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t1
        done += eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {n: k.launches for n, k in _build.kernels().items()}
        waves = eng.decode_dispatches - waves0
        scans = stats.scan_dispatches - scans0
        by_id = {r.request_id: r.tokens for r in done}
        out = np.stack([by_id[r] for r in rids])        # [R, B, T0 + steps]
        gen = out[:, :, T0:].reshape(R * B, steps)
        acc = float((gen == truth).mean())
        tokens = R * B * steps
        log("serve.run", t1, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{tokens / wall:.1f}", generated_tokens=tokens,
            first_step_s=f"{t_first:.3f}",
            decode_ms_per_wave=f"{(wall - t_first) / max(waves, 1) * 1e3:.2f}",
            decode_waves=waves,
            mean_wave_rows=f"{eng.pool.stats.mean_wave():.2f}",
            scan_dispatches=scans,
            coalescing=f"{stats.coalescing_factor():.1f}",
            continuation_accuracy=f"{acc:.4f}", launches=launches)
        want = {"decode_attn_launch": cfg.n_layers * waves,
                "ivf_scan_launch": scans, "chamvs_scan_launch": scans}
        if scans <= 0 or waves <= 0 or launches != want:
            raise AssertionError(f"launches {launches} != expected {want}")
        return dict(tps=tokens / wall, acc=acc, gen=gen, launches=launches,
                    ms_wave=(wall - t_first) / waves * 1e3)

    runs = [drive() for _ in range(sizes["repeats"])]
    if not bool(ok):
        raise AssertionError("non-finite logits or out-of-range ids")
    tps = sorted(r["tps"] for r in runs)
    ms_wave = sorted(r["ms_wave"] for r in runs)
    log("serve.summary", t0, tokens_per_s_median=f"{tps[len(tps) // 2]:.1f}",
        tokens_per_s_range=f"{tps[0]:.1f}-{tps[-1]:.1f}",
        decode_ms_per_wave_median=f"{ms_wave[len(ms_wave) // 2]:.2f}",
        decode_ms_per_wave_range=f"{ms_wave[0]:.2f}-{ms_wave[-1]:.2f}",
        continuation_accuracy=[f"{r['acc']:.4f}" for r in runs],
        tokens_equal_across_runs=all(np.array_equal(r["gen"], runs[0]["gen"])
                                     for r in runs))
    profile_waves(torch, eng, prompts, steps=16)
    sampled_request(torch, eng, prompts[0], cfg.vocab_size, steps=16)
    return eng, prompts, runs[0]["launches"]


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


def profile_waves(torch, eng, prompts, steps):
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
    log("serve.profile", t0, decode_waves=steps - 1,
        wall_ms=f"{wall * 1e3:.1f}", device_busy_ms=f"{busy_us / 1e3:.1f}",
        device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        device_events=len(rows))
    for us, count, key in rows[:12]:
        print(f"  device {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}",
              flush=True)


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

    sizes = dict(FULL)
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
    torch.cuda.empty_cache()

    eng, prompts, launches = serve(torch, dev, arch, cfg, params, corpus,
                                   ds, sizes)
    accuracy_witness(torch, eng, arch, cfg, keys, ds, corpus, prompts, sizes)
    for name, sym in (("decode_attn", "decode_attn_launch"),
                      ("ivf_scan", "ivf_scan_launch"),
                      ("fused_scan", "chamvs_scan_launch")):
        report[name]["launches"] = launches[sym]
    log("total", t_all, peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(json.dumps({"kernels": [report[k] for k in
                                  ("decode_attn", "ivf_scan", "fused_scan")]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
