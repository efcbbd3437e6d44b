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
     function, and the least time the card could take for the work
     (decode attention also beside a copy of as many bytes).
     The IVF probe also runs at SYN-512's published nlist (32 768
     seeded random centroids of 512 floats; a log line only). The staged
     scan's kernels run at shard 0's staged shapes: adc_scan over the
     wave's 1024 (query, probe) entries, read in place as the staged
     scan reads them (the report row) and through the reference's
     gathered signature, timed beside the gather the staged scan no
     longer makes; shared_scan of the wave's LUTs over the union of its
     probed lists (beside its shared-memory lookup floor), and the
     hierarchical top-k over the wave's staged ADC distance rows (one
     launch a call, beside a read of the same bytes).
  4. serve: 8 requests x 4 rows through RalmEngine.from_config (wave
     decode, fused scan, async retrieval), 64 greedy tokens each, driven
     ``repeats`` (2) times (tokens/s as median and range); before each run the
     kernels' launch counters are zeroed, and just after they must match
     the engine's wave and scan dispatch counts. Then serve.staged: the
     same traffic through a staged deployment (search_config(fused=False):
     one adc_scan launch per shard per flush), two runs alternating
     with two more fused runs, whose tokens must all equal the fused
     runs'. Then serve.disaggregated: the same traffic through
     EngineConfig(disaggregate=True, ret_devices=2), the LM pool in this
     process and two memory-node processes on the card (one DB shard
     each; each probes with the IVF kernel and scans with adc_scan),
     two runs alternating with two of the monolithic engine of the
     same config with synchronous retrieval and the staged scan: tokens
     equal in every run, one wave's search bit-equal, each node's probe
     and adc_scan launches equal to the searches it served (and none
     here), tokens/s beside the monolithic runs', PoolTimes medians and
     the Fig. 13 optimal ratio, the fabric's round trips, bytes and ms
     per search and gather, each node's card and memory, and no node
     process alive after close(). Then serve.spec: the same traffic with speculative retrieval
     (speculate_k 1 and 2, each run once beside a fused run, 32 tokens
     a row: ``short_steps``), whose
     tokens must equal the fused runs' and whose speculation counters
     are printed; and retrieval.cache: the service's result cache on the
     same datastore with one wave's real queries (full hit without a
     launch, half hit that scans only the missed rows, stale lookup, and
     a raising scan that leaves (+inf, -1) partial results and
     re-raises). Then serve.chaos.*: the same traffic through
     EngineConfig(shard_replicas=2, chaos_plan=<a FaultPlan saved under
     build/chaos/>): none (tokens equal, every fault counter 0, tokens/s
     in alternating pairs with runs without the layer), spec_k1 (the
     layer with speculation), crash and hang on one replica (tokens
     equal, the matching counters), shard_down (every flush partial; on
     one wave's queries the survivors' result bit-equal to flat_merge of
     shard 0, fused and staged) and loss (flushes without a target launch
     nothing and serve (+inf, -1) on the card; a later run's tokens
     equal); in every run the IVF probe and scan launches equal the
     scans the pipeline ran. obs.trace: one traced crash-plan run,
     written under build/trace/ and validated, beside an untraced run.
  5. the serving surface: kernel.nprobe_rungs (the IVF probe and the
     fused scan at the degrade ladder's nprobe rungs, 16 down to 1, on
     one wave's real queries, against their plain versions, timed beside
     their bounds) and kernel.decode_attn_per_seq (decode attention with
     slots=None over 4 x 512 per-request caches at positions 448-511);
     serve.degrade.<rung>: DegradePolicy.apply(i) on the long-lived fused
     engine for every rung (baseline, nprobe/2 ... nprobe/32, interval
     x4, knn-off) and the serve traffic at 32 tokens a row, whose
     tokens must equal an
     engine pinned at that rung, with no probe or scan launch at knn-off;
     serve.per_sequence: 2 requests through EngineConfig(wave_decode=
     False) beside a wave run of them, decode attention launched 24 x 63
     x 2 times; gateway.*: a Gateway over a fused engine (kv_slots 32)
     started with start_background(), one streaming client on a raw
     socket (single: tokens equal to an in-process run), 32 at once
     (load: every request 64 tokens and [DONE], no slot left, launches
     = flushes), 64 into 32 slots (overload: the ladder steps down and
     back to level 0, every admitted request completes, 503s counted)
     and one that disconnects after two tokens (cancel: its slot comes
     back, the next request's tokens equal its solo run), with TTFT and
     TPOT server-side (RequestTiming) and client-side (arrival on the
     socket). Where two runs put a row in waves of different shapes
     (per_sequence against its wave run, load against an offline run),
     the tokens may differ only at near ties (near_tie_check: the first
     differing token's score gap within twice the two runs' largest
     score difference over their common prefix, and at most a quarter
     of the requests differing).
     After the timed runs: one sampled request drawing from a
     CUDA generator, a profile of the fused and of the staged decode
     waves, and the accuracy witness: the same traffic with exact
     (flat L2) search over every key in place of the PQ index, with the
     rate at which each search's top-1 / top-K holds the true prefix's
     own key. Each profile (fused, staged, the armed layer without
     faults, and each degrade rung) prints the device time per decode
     wave and the host's time in CUDA synchronize calls.
  6. the paper's other three RALMs (paper.*), after Dec-S's engines and
     index are freed, each at full published width with seeded weights,
     one after the other: Dec-L (24 of its 96 layers, d_model 1024,
     kNN-LM), EncDec-S and EncDec-L (2 encoder layers + 24 or 72 of 96
     decoder layers, RETRO at K 10, chunks of 64 tokens; xwv and xwo
     scaled by RETRO_XSCALE so that retrieval moves tokens). Each builds
     its own index from its own hidden states over Dec-S's corpus
     (SYN-1024's shapes at d_model 1024: m 64; SYN-512's at 512), RETRO
     with a chunk table (row i = the 64 tokens after key i's position),
     and serves Dec-S's traffic fused and staged (tokens equal, launches
     held to the dispatches as in phase 4: decode attention = layers x
     waves, probe and scan = flushes). Dec-L: the kernels at its shapes
     (decode attention at 16 KV heads, the IVF probe at D 1024, the
     fused scan and adc_scan at m 64) against their plain versions and
     timed, two fused runs (tokens/s median, accuracy). RETRO at each
     interval (EncDec-S 8 and 64, EncDec-L 8): flushes fewer than waves,
     the share of tokens that differ from a mode="none" run and from a
     run without a retriever (> 0), the pooled encoder buffer's shape,
     and at interval 8 the per-sequence twin held by the near-tie rule.
     Each model's decode waves are profiled, and its peak memory
     printed. Their launch counts and kernel times join the kernel
     report's rows under keys suffixed with the model's name. Dec-L's
     corpus is cut to 512 docs, the RETRO models' to 2048, and every
     model generates 32 tokens a row (``short_steps``).
  7. the dense assigned backbones (assigned.*), after the paper's:
     decode attention at Llama-3-405B's (128:8) and Qwen2-VL-72B's
     (64:8) head layouts at D 128 on a seeded pool (neither model fits
     the card); then Qwen2-0.5B (GQA 14:2, QKV bias), Phi-3-mini (MHA,
     d_head 96, untied) and Gemma-3-4B (5:1 local:global, 1024-slot
     rings, d_head 256, vocab 262 144) at full published width and
     depth with seeded weights, one after the other: each builds its
     keys over its own seeded corpus (tokens below its vocab) and an
     IVF-PQ index at m = d_model // 16 (56, 192, 160), runs the kernels
     at its shapes (Gemma-3's local ring too) against their plain
     versions, serves Dec-S's traffic fused and staged (tokens equal,
     launches held to the dispatches; Gemma-3's prompts are 1040 tokens,
     so its rings wrap in prefill and decode), prints the prefill's
     peak memory for one request's 4 rows, tokens/s, accuracy and a
     profile of 3 decode waves. The rows join the kernel report under
     ``_<model>`` keys.
  8. the non-dense assigned backbones (assigned.*), after the dense
     ones: decode attention at DBRX-132B's 48:8 D 128 head layout on a
     seeded pool, and one full-width DBRX MoE FFN layer (16 experts of
     d_ff 10 752, top-4, 6.3 GB of expert weights) on a 32-row wave, two
     runs bit-equal, timed against the bytes of its experts (DBRX does
     not fit the card); then Hymba-1.5B (attention and a Mamba head in
     every block, depth cut to 16 of 32 layers: 1 global + 15 local with
     1024-slot rings, 25:5 heads of 64), RWKV-6-3B (no attention: decode-attention launches
     must be 0; its recurrent state rides in the pool's rows) and
     Phi-3.5-MoE (16 experts top-2, 32:8 heads of 128; depth cut to 16 of
     32 layers, m cut to 128) at full width with seeded weights, each
     with its own corpus and index (m 100, 160, 128), the kernels at its
     shapes, the serve traffic fused and staged (tokens equal, launches
     held to the dispatches), prefill time and peak memory for 4 rows,
     the weight-read bound a wave, and a profile of 3 decode waves; then
     SeamlessM4T-medium (12 + 12 layers, 16:16 heads of 64, vocab
     256 206) through RETRO at interval 64, K 10, chunks of 64, fused,
     staged, without retrieval and without a retriever (the share of
     tokens retrieval moves must be > 0).
  9. training (train.*), after the serving phases, with no kernel of
     the port on its path (the reference's training reaches no Pallas
     call): train.dec_s trains Dec-S at full width (101.2M parameters,
     bf16, seeded weights) on a seeded Markov-chain corpus read through
     MemmapTokens (400 windows of 513 tokens under build/train/): seq
     512, global batch 16 in 2 micro-batches, remat, AdamW, 20 steps
     through the TrainController with a checkpoint every 5; it prints
     the median step ms over steps 5-20, tokens/s, the share of the
     bf16 dense peak (989 TFLOP/s) that 6 x N x tokens a step reaches,
     peak memory, a synchronous checkpoint's write ms, and the losses,
     which must fall. train.dec_s.resume runs it again crashed after
     step 10 (SimulatedFailure) and resumed from the checkpoint with
     fresh weights: every loss must equal the straight run's bit for
     bit. train.encdec_s runs examples.train_retro --full (EncDec-S,
     seq 512, batch 64, 640 encoder rows; steps cut from 200 to 8),
     whose loss must fall. train.dp trains Dec-S on 2 data-parallel
     ranks sharing the card (gloo, staged through host memory) for 4
     steps with a checkpoint at 3; each of the first 3 losses must be
     within 1e-3 of a one-rank run of the same global batch in this
     process, and step 4 resumed on one rank from that checkpoint
     (elastic_restore) within 1e-3 of the ranks'; it prints the
     all-reduce's MB and ms a step. train.tp does the same on a 2 x 2
     (data x model) mesh of 4 ranks sharing the card, each holding only
     its shards of the parameters and moments (launch.steps' sharded
     step: FSDP over "data", tensor parallelism over "model"): every
     rank's resident parameter and moment bytes must equal the dry
     run's count for one device of the mesh; it prints them beside one
     rank's, the step ms and each axis's collective MB and ms a step.
     train.flash_attn holds the FA2
     autograd Function at Dec-S's and EncDec-S's training shapes
     against autograd through the plain masked softmax in float32 (out,
     dq, dk, dv within 2^-8 of each one's range) and times its forward
     and backward beside SDPA's (a yardstick only). Each line carries
     the card's name and power limit.
 10. the dry run's step builders and the quickstart twin, after
     training. steps.serve reuses phase 2's weights and index, which
     stay on the card through phases 6-9 (~0.6 GB): it runs
     launch.steps' build_prefill_step and build_serve_step for Dec-S at
     decode_32k on a one-position mesh at full width, over the
     4 194 304-key index and its payload: 32 rows (the 8 x 4 prompts,
     447 tokens prefilled), a cache of 512, then 16 greedy steps (median
     ms a step by CUDA events; decode attention launched 24 x 16 times,
     the IVF probe and the fused scan 16). Step 8's state and the
     weights and index are copied to the CPU (the copy timed) and the
     step is run there through the plain versions: log-probs within
     2^-5 of their range, greedy tokens equal or near ties
     (near_tie_check); the CPU step searches with the card's query (the
     bf16 hidden states of the two devices part in their last bits,
     which can move a neighbour across the K-th boundary), and its
     distances must be within 1e-5 relative of the card's and its ids
     identical but where two distances tie within 1e-5
     (ivfpq.id_swaps counts such swaps). steps.mesh runs the same
     prefill and 6 greedy steps with the step builders' rank group, on
     a 2 x 2 mesh of 4 ranks sharing the card over gloo (each the entry
     mesh_rank on its shards of the weights, the index, one shard a
     data rank, and the payload, saved under build/mesh/; the caches
     split over sequence on "model" and over rows on "data", decode
     attention in its partial mode merged across the model ranks): its
     tokens held to steps.serve's first 6 by near_tie_check, every
     rank's resident bytes equal to the dry run's per-device count of
     the same arguments, every rank's launches (the partial mode 24 x
     6, the IVF probe and the fused scan 6, the whole-wave decode
     attention 0), step ms and each axis's collective MB and ms a step;
     kernel.decode_attn_partial before it holds the partial mode, two
     slot ranges merged, against its plain version (2^-5) and a float32
     oracle (2^-8) at a rank's shapes and times it. quickstart: the
     quickstart twin's main() on the card, R10@32, and the same search
     on the CPU by the same rule.
     search.tools runs earlier, at the end of phase 5, while the 8.6 GB
     of keys are still on the card: exact_search over every key on the
     card and on the CPU (the same rule, the tolerance taken on the
     |q|^2 + |k|^2 terms the distances cancel from; the keys' copy to
     the host timed), recall_at_k of the fused search against it, and
     search_single fused and staged on the 32 kernel queries, ids equal
     to each other and to a RetrievalService built as the engine builds
     one (1 probe + 1 fused scan launch a fused call, 1 probe + 1
     adc_scan a shard a staged one).

The last two lines are the kernel report and the device line, each one
JSON object. Without a GPU (or outside the repository) it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import socket
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM float32, outside tensor cores
# ``short_steps``: the tokens a row of the phases after Dec-S's main
# serve runs (speculation, the degrade rungs, the other models), cut
# from 64 for the script's time
FULL = dict(n_docs=8192, doc_len=513, prompt_len=448, steps=64,
            short_steps=32,
            requests=8, rows=4, nlist=256, nprobe=32, m=32, max_seq=512,
            train_stride=16, repeats=2, kv_slots=32, per_seq_requests=2,
            cancel_steps=16)


def log(phase: str, t0: float, **kv) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.3f}s " +
          " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
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
    short kernel's wrapper takes tens of microseconds of Python). A
    function whose runs add up to ``BUDGET_MS`` stops there, after at
    least ``MIN_ITERS`` runs (the plain versions: 10-300 ms a run)."""

    HOLD_CYCLES = 20_000_000
    MIN_ITERS, BUDGET_MS = 5, 1000.0

    def __init__(self, torch, iters: int = 25, warmup: int = 3):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        while len(times) < self.iters and (
                len(times) < self.MIN_ITERS or sum(times) < self.BUDGET_MS):
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

def build_index(torch, dev, label, cfg, params, docs, sizes, m,
                chunk_len=None):
    """The model's own keys over ``docs`` (its decoder's hidden state at
    every prefix) and an IVF-PQ datastore over them (``m``
    sub-quantizers, quantizers trained on every ``train_stride``th key),
    with the next-token table and, for RETRO (``chunk_len``), the chunk
    table; returns (keys, ds)."""
    from repro_torch.serve import DatastoreBuilder

    builder = DatastoreBuilder(dim=cfg.d_model, nlist=sizes["nlist"], m=m,
                               list_cap=None, device=str(dev))
    t1 = time.perf_counter()
    keys, nxt = builder.corpus_keys(params, cfg, docs,
                                    batch=sizes.get("key_batch", 64))
    torch.cuda.synchronize()
    log(f"{label}.corpus_keys", t1, keys=tuple(keys.shape),
        docs=docs.shape[0], doc_len=docs.shape[1])
    t2 = time.perf_counter()
    chunks = None if chunk_len is None else chunk_table(
        torch, torch.from_numpy(docs).to(dev), chunk_len)
    train = keys[::sizes["train_stride"]]
    ds = builder.build(keys, payload_tokens=nxt, chunk_table=chunks,
                       train_vectors=train)
    lens = torch.stack([s.list_len for s in ds.shards]).float()
    log(f"{label}.datastore", t2, vectors=ds.num_vectors, dim=cfg.d_model,
        nlist=sizes["nlist"], m=ds.index_cfg.m, shards=ds.num_shards,
        list_cap=ds.index_cfg.list_cap,
        mean_list_slice=round(float(lens.mean()), 1),
        max_list_slice=int(lens.max()),
        chunk_table=None if chunks is None else tuple(chunks.shape),
        train_vectors=int(train.shape[0]))
    return keys, ds


def kernel_queries(torch, dev, keys, sizes):
    """One wave's worth of queries for the kernel phases: seeded picks
    of the keys plus a little noise."""
    W = sizes["requests"] * sizes["rows"]
    g = torch.Generator(device=dev).manual_seed(2)
    pick = torch.randint(0, keys.shape[0], (W,), generator=g, device=dev)
    return (keys[pick] + 0.01 * torch.randn(
        (W, keys.shape[1]), generator=g, device=dev)).contiguous()


def setup(dev, sizes):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    arch = get_arch("dec_s")
    cfg = arch.model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, cfg.vocab_size,
                          size=(sizes["n_docs"], sizes["doc_len"]),
                          dtype=np.int32)
    log("setup.params", t0, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        params=n_tensor_params(params), dtype=cfg.dtype)
    keys, ds = build_index(torch, dev, "setup", cfg, params, corpus, sizes,
                           sizes["m"])
    print(f"[cuts] vectors {ds.num_vectors} vs SYN-512's 1e9 "
          f"({1e9 / ds.num_vectors:.0f}x fewer); nlist {sizes['nlist']} "
          f"vs the paper's 32768; quantizers trained on every "
          f"{sizes['train_stride']}th key; model depth not cut", flush=True)
    return arch, cfg, params, corpus, keys, ds


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def decode_case(torch, dev, g, W, P, H, KV, D, S, window, ring, pos_lo,
                pos_hi, kv_len):
    """One decode-attention launch over a seeded pool of ``P`` rows of
    ``S`` slots (the wave's rows at random slots, positions drawn from
    [pos_lo, pos_hi]), held against the plain version (2^-5 of the output
    range) and a float32 oracle (2^-8); returns the inputs and errors."""
    from repro_torch.kernels.decode_attn import ops as da

    k = torch.randn((P, S, KV, D), generator=g, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn((P, S, KV, D), generator=g, device=dev
                    ).to(torch.bfloat16)
    q = torch.randn((W, 1, H, D), generator=g, device=dev
                    ).to(torch.bfloat16)
    slots = torch.randperm(P - 1, generator=g, device=dev)[:W].int()
    pos = torch.randint(pos_lo, pos_hi + 1, (W,), generator=g,
                        device=dev).int()
    kw = dict(window=window, ring=ring, slots=slots, kv_len=kv_len)
    out = da.decode_attention(q, k, v, pos, **kw)
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
    return dict(q=q, k=k, v=v, slots=slots, pos=pos, kw=kw, plain=plain,
                err=err, err32=err32, tol=tol, H=H, KV=KV, D=D, S=S)


def decode_timed(torch, dev, timer, c):
    """Kernel, plain version, SDPA (the one-call yardstick, with the
    bool validity mask; GQA through ``enable_gqa``), a copy that moves as
    many bytes as the kernel must (the streaming yardstick: it reads half
    of them and writes the other half), the bytes (K and V of every
    valid slot once, q and the output, slots and positions) and the
    bound, for one ``decode_case``."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import ops as da
    from repro_torch.kernels.decode_attn.ref import decode_validity

    q, k, v, pos, kw, plain = (c[n] for n in ("q", "k", "v", "pos", "kw",
                                              "plain"))
    H, KV, D = c["H"], c["KV"], c["D"]
    W = q.shape[0]
    ms = timer(lambda: da.decode_attention(q, k, v, pos, **kw))
    plain_ms = timer(lambda: da.ref_decode_attention(
        q, *da._gather_rows(q, k, v, kw["slots"], kw["kv_len"], kw["ring"]),
        pos, window=kw["window"], ring=kw["ring"]))
    valid = decode_validity(pos, plain[0].shape[1], kw["window"], kw["ring"])
    mask = valid[:, None, None, :]
    qs = q.transpose(1, 2)                       # [W, H, 1, D]
    ks, vs = plain[0].transpose(1, 2), plain[1].transpose(1, 2)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=H != KV))
    n_valid = int(valid.sum())
    nbytes = 2 * n_valid * KV * D * 2 + 2 * q.numel() * 2 + W * 8
    src = torch.empty(nbytes // 4, dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    copy_ms = timer(lambda: dst.copy_(src))
    bound_ms, bound_by = bound(nbytes, 4 * n_valid * H * D)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, copy_ms=copy_ms,
                nbytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)


def decode_log(label, t0, c, t, W, P, split, **extra):
    log(label, t0, shape=f"W={W},H={c['H']},KV={c['KV']},D={c['D']},"
        f"S={c['S']},P={P},window={c['kw']['window']},ring={c['kw']['ring']}",
        max_abs_err=f"{c['err']:.3e}", tol=f"{c['tol']:.3e}",
        err_vs_f32=f"{c['err32']:.3e}", split=split,
        ms=f"{t['ms']:.4f}", plain_ms=f"{t['plain_ms']:.4f}",
        sdpa_ms=f"{t['library_ms']:.4f}", bound_ms=f"{t['bound_ms']:.4f}",
        bytes=t["nbytes"], copy_same_bytes_ms=f"{t['copy_ms']:.4f}",
        kernel_tb_s=f"{t['nbytes'] / t['ms'] / 1e9:.3f}",
        copy_tb_s=f"{t['nbytes'] / t['copy_ms'] / 1e9:.3f}", **extra)


def kernel_decode_attn(torch, dev, timer, cfg, sizes, report,
                       label="kernel.decode_attn"):
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn import ops as da

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(1)
    W = sizes["requests"] * sizes["rows"]
    P, S = W + 1, sizes["max_seq"]      # the serve pool: W rows + scratch

    def case(H, KV, D, S, window, ring, pos_lo, pos_hi, kv_len):
        return decode_case(torch, dev, g, W, P, H, KV, D, S, window, ring,
                           pos_lo, pos_hi, kv_len)

    # the serve phase's shape: the model's heads, pool of W+1 rows, ragged
    # positions over the generation window, kv_len = the pool's max_seq
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    main = case(H, KV, D, S, 0, False, sizes["prompt_len"], S - 1, S)
    extra = [case(8, 4, 128, S, 0, False, 1, S - 1, S),            # G=2
             case(H, KV, D, 64, 64, True, 0, 700, None),           # ring
             case(H, KV, D, S, 48, False, 100, S - 1, S)]          # window
    t = decode_timed(torch, dev, timer, main)
    # the serve's first kv_len crop: the prompt's length, the pool's
    # 16-slot quantum -> positions T0..T0+15 read T0+16 slots
    crop = case(H, KV, D, S, 0, False, sizes["prompt_len"],
                sizes["prompt_len"] + 15, sizes["prompt_len"] + 16)
    tc = decode_timed(torch, dev, timer, crop)
    kv_c = crop["kw"]["kv_len"]
    sms = _build.sm_count(dev)
    res = da.resident_blocks(D, H // KV)
    split = da.pick_split(W, KV, S, sms, None, res)
    split_c = da.pick_split(W, KV, kv_c, sms, None, res)
    report["decode_attn"] = dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/kernel.py:109",
        max_abs_err=max(main["err"], crop["err"]), ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        **{f"ms_kv{kv_c}": tc["ms"], f"library_ms_kv{kv_c}": tc["library_ms"],
           f"bound_ms_kv{kv_c}": tc["bound_ms"]})
    decode_log(label, t0, main, t, W, P, split,
               extra_cases_err=[f"{c['err']:.3e}" for c in extra + [crop]],
               blocks=W * KV * -(-S // split))
    decode_log(f"{label}_kv{kv_c}", t0, crop, tc, W, P, split_c,
               kv_len=kv_c, blocks=W * KV * -(-kv_c // split_c))


def check_probe(torch, queries, cents, dk, ik, dp, ip):
    """The IVF probe's ids against the plain version's: they may differ
    only where the two candidates' distances tie within 1e-5 relative
    (the kernel's FMA order differs from the GEMM's); the distances agree
    within 1e-5 relative. Returns (id mismatches, max abs, max rel err)."""
    from repro_torch.core.kmeans import _pairwise_sq_l2

    full = _pairwise_sq_l2(queries, cents)
    mism = ik != ip
    dk_of = torch.gather(full, 1, ik.long())
    dp_of = torch.gather(full, 1, ip.long())
    near = (dk_of - dp_of).abs() <= 1e-5 * dp_of.abs()
    if bool((mism & ~near).any()):
        raise AssertionError(f"ivf_scan ids differ beyond near-ties: "
                             f"{int((mism & ~near).sum())}")
    rel = ((dk - dp).abs() / dp.abs().clamp(min=1e-30)).max().item()
    if rel > 1e-5:
        raise AssertionError(f"ivf_scan distances differ: rel {rel}")
    return int(mism.sum()), (dk - dp).abs().max().item(), rel


def probe_bound(nq, nlist, D, nprobe):
    """The IVF probe's bound: the centroids and queries read once, the
    (dist, id) outputs written once; 2 D + 3 operations a pair."""
    nbytes = (nlist * D + nq * D) * 4 + nq * nprobe * 8
    return bound(nbytes, 2 * nq * nlist * D + 3 * nq * nlist)


def kernel_ivf_scan(torch, dev, timer, ds, queries, sizes, report,
                    label="kernel.ivf_scan"):
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import ops as iv

    t0 = time.perf_counter()
    cents = ds.params.coarse_centroids
    nprobe = sizes["nprobe"]
    dk, ik = iv.ivf_index_scan(queries, cents, nprobe)
    dp, ip = iv.ref_ivf_scan(queries, cents, nprobe)
    torch.cuda.synchronize()
    mism, err, rel = check_probe(torch, queries, cents, dk, ik, dp, ip)
    ms = timer(lambda: iv.ivf_index_scan(queries, cents, nprobe))
    plain_ms = timer(lambda: iv.ref_ivf_scan(queries, cents, nprobe))
    nq, D = queries.shape
    nlist = cents.shape[0]
    bound_ms, bound_by = probe_bound(nq, nlist, D, nprobe)
    tq, per_block, splits = iv.probe_grid(nq, nlist, _build.sm_count(dev))
    report["ivf_scan"] = dict(
        name="ivf_scan", route="cuda", source="src/repro_torch/csrc/ivf_scan.cu",
        replaces="src/repro/kernels/ivf_scan/kernel.py:51",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    log(label, t0, shape=f"nq={nq},nlist={nlist},D={D},"
        f"nprobe={nprobe}", id_mismatch_near_ties=mism,
        max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}", queries_per_block=tq,
        centroids_per_block=per_block, blocks=-(-nq // tq) * splits)
    return ik


def kernel_ivf_scan_nlist32768(torch, dev, timer, sizes):
    """The IVF probe at SYN-512's published nlist (32 768 centroids of
    512 floats, 64 MB): 32 seeded queries against seeded random
    centroids. A log line only; the report row is the serve shape's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import ops as iv

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(4)
    nq, nlist, D, nprobe = 32, 32768, 512, sizes["nprobe"]
    cents = torch.randn((nlist, D), generator=g, device=dev)
    queries = torch.randn((nq, D), generator=g, device=dev)
    dk, ik = iv.ivf_index_scan(queries, cents, nprobe)
    dp, ip = iv.ref_ivf_scan(queries, cents, nprobe)
    torch.cuda.synchronize()
    mism, err, rel = check_probe(torch, queries, cents, dk, ik, dp, ip)
    ms = timer(lambda: iv.ivf_index_scan(queries, cents, nprobe))
    plain_ms = timer(lambda: iv.ref_ivf_scan(queries, cents, nprobe))
    bound_ms, bound_by = probe_bound(nq, nlist, D, nprobe)
    tq, per_block, splits = iv.probe_grid(nq, nlist, _build.sm_count(dev))
    log("kernel.ivf_scan_nlist32768", t0, shape=f"nq={nq},nlist={nlist},"
        f"D={D},nprobe={nprobe}", id_mismatch_near_ties=mism,
        max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, queries_per_block=tq,
        centroids_per_block=per_block, blocks=-(-nq // tq) * splits)


def kernel_fused_scan(torch, dev, timer, ds, queries, probe_ids, kk, report,
                      label="kernel.fused_scan"):
    from repro_torch.core import ivfpq
    from repro_torch.core.chamvs import stack_shards
    from repro_torch.kernels import _build
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
    # a second yardstick: the shared-memory lookups, counted on query 0's
    # rows in the kernel's order, at the card's top SM clock
    sms = _build.sm_count(dev)
    groups = cs.scan_groups(S, nq, nprobe, st.codes.shape[2], kk, sms)
    p0 = probe_ids[0].long()                # query 0's rows, probe by probe
    valid = (torch.arange(st.codes.shape[2], device=dev)
             < st.list_len[:, p0, None])
    waves = lookup_wavefronts(torch, st.codes[:, p0][valid])
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    floor_ms = rows * m / 32 * waves / (sms * clock_hz) * 1e3
    report["fused_scan"] = dict(
        name="fused_scan", route="cuda",
        source="src/repro_torch/csrc/chamvs_scan.cu",
        replaces="src/repro/kernels/chamvs_scan/kernel.py:93",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    log(label, t0, shape=f"S={S},nq={nq},nprobe={nprobe},"
        f"cap={st.codes.shape[2]},m={m},kk={kk}",
        mean_len=f"{float(lens.mean()):.1f}", ids_equal=True,
        max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}", groups=groups, blocks=S * nq * groups,
        wavefronts_per_warp_lookup=f"{waves:.3f}",
        sm_clock_mhz=f"{clock_hz / 1e6:.0f}",
        lookup_floor_ms=f"{floor_ms:.4f}")


def lookup_wavefronts(torch, rows):
    """Mean shared-memory wavefronts of one warp's LUT lookup into one
    sub-space's 256 floats, over code rows [n, m] in a kernel's order (32
    consecutive rows to a warp): a lookup takes as many wavefronts (one a
    clock per SM) as the most distinct codes that share one of the 32
    banks."""
    m = rows.shape[1]
    w = rows.shape[0] // 32
    total, count = 0.0, 0
    for c in range(0, w, 4096):                 # 4096 warps at a time
        x = rows[c * 32:min(w, c + 4096) * 32].view(-1, 32, m).long()
        present = torch.zeros((x.shape[0], m, 256), dtype=torch.bool,
                              device=rows.device)
        present.scatter_(2, x.transpose(1, 2), True)
        per_bank = present.view(x.shape[0], m, 8, 32).sum(2)
        total += float(per_bank.amax(-1).double().sum())
        count += x.shape[0] * m
    return total / count


def kernel_adc_scan(torch, dev, timer, ds, queries, probe_ids, kk, report,
                    label="kernel.adc_scan"):
    """adc_scan at the staged serve shape of shard 0, through the entry
    the staged scan calls (``probed_adc_topk``: the shard's lists and
    the LUTs read in place), and through the reference's gathered
    signature (``pq_adc_topk``) on the copies the staged scan used to
    make; returns the wave's staged ADC distance rows [nq, nprobe * cap]
    (+inf past each list's length) for the hierarchical top-k phase."""
    from repro_torch.core import ivfpq
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.kernels.pq_adc import ref as pq_ref

    t0 = time.perf_counter()
    icfg, shard = ds.index_cfg, ds.shards[0]
    nq, nprobe = probe_ids.shape
    B, cap, m, ksub = nq * nprobe, icfg.list_cap, icfg.m, icfg.ksub
    p = probe_ids.long()
    luts4 = ivfpq.compute_luts(ds.params, queries, probe_ids, icfg)
    k = min(kk, cap)

    def gather():
        """What the staged scan gathered before it read in place."""
        return (luts4.reshape(B, m, ksub), shard.codes[p].reshape(B, cap, m),
                shard.list_len[p].reshape(B), shard.ids[p].reshape(B, cap))

    luts, codes, lens, _ = gather()
    di, ii = pq.probed_adc_topk(luts4, shard.codes, shard.list_len,
                                probe_ids, k)
    dk, ik = pq.pq_adc_topk(luts, codes, lens, k)
    dp, ip = pq_ref.ref_pq_adc_topk(luts, codes, lens, k)
    torch.cuda.synchronize()
    di, ii = di.reshape(B, k), ii.reshape(B, k)
    for name, d, i in (("in place", di, ii), ("gathered", dk, ik)):
        if not torch.equal(i, ip):
            raise AssertionError(f"adc_scan ({name}) ids differ: "
                                 f"{int((i != ip).sum())} of {i.numel()}")
        if not torch.equal(d, dp):
            raise AssertionError(f"adc_scan ({name}) distances differ from "
                                 "the plain version's (both sum in index "
                                 "order)")
    fin = torch.isfinite(dp)
    err = max((di - dp)[fin].abs().max().item(),
              (dk - dp)[fin].abs().max().item())
    ms = timer(lambda: pq.probed_adc_topk(luts4, shard.codes,
                                          shard.list_len, probe_ids, k))
    gathered_ms = timer(lambda: pq.pq_adc_topk(luts, codes, lens, k))
    gather_ms = timer(gather)
    plain_ms = timer(lambda: pq_ref.ref_pq_adc_topk(luts, codes, lens, k))
    rows = float(lens.double().sum())
    # codes of the valid rows, the distinct LUTs (one per query when the
    # probe axis is a stride-0 view, else one per entry), the probe ids,
    # the lens, and the (dist, row) outputs; the gathered entry reads one
    # LUT per entry
    n_luts = nq * (1 if luts4.stride(1) == 0 else nprobe)
    tail = B * 4 + B * 4 + B * k * 8
    nbytes = rows * m + n_luts * m * ksub * 4 + tail
    bound_ms, bound_by = bound(nbytes, rows * m)
    g_bound_ms, _ = bound(rows * m + B * m * ksub * 4 + tail, rows * m)
    chunk_rows = pq.adc_chunk_rows(B, cap, _build.sm_count(dev))
    report["adc_scan"] = dict(
        name="adc_scan", route="cuda", source="src/repro_torch/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc/kernel.py:101",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    log(label, t0, shape=f"B={B},n={cap},m={m},ksub={ksub},k={k}",
        mean_len=f"{rows / B:.1f}", ids_equal=True, dists_bit_equal=True,
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}", gathered_ms=f"{gathered_ms:.4f}",
        gathered_bound_ms=f"{g_bound_ms:.4f}",
        gather_ms=f"{gather_ms:.4f}", chunk_rows=chunk_rows,
        blocks=int((torch.clamp((lens.double() / chunk_rows).ceil(), min=1)
                    ).sum()))
    d = pq_ref.ref_adc_batch(luts, codes)
    valid = torch.arange(cap, device=dev)[None, :] < lens[:, None]
    return torch.where(valid, d, torch.full_like(d, float("inf"))
                       ).reshape(nq, -1)


def kernel_shared_scan(torch, dev, timer, ds, queries, probe_ids, report):
    """shared_scan: the wave's non-residual LUTs against the valid code
    rows of the union of the lists the wave probes in shard 0."""
    import torch.nn.functional as F
    from repro_torch.core import ivfpq
    from repro_torch.kernels import _build
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
    # the shared-memory lookups: n * q * m terms of 4 bytes, a warp's 32
    # rows a lookup (counted on these rows, at the card's top SM clock)
    sms = _build.sm_count(dev)
    waves = lookup_wavefronts(torch, codes)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    floor_ms = n * q * m / 32 * waves / (sms * clock_hz) * 1e3
    tq = pq.shared_tile_q(q, m, ksub)
    rows = pq.shared_rows(n, -(-q // tq), sms)
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
        bound_ms=f"{bound_ms:.4f}",
        wavefronts_per_warp_lookup=f"{waves:.3f}",
        sm_clock_mhz=f"{clock_hz / 1e6:.0f}",
        lookup_floor_ms=f"{floor_ms:.4f}", queries_per_block=tq,
        query_tiles=-(-q // tq), rows_per_block=rows,
        blocks=-(-q // tq) * -(-n // rows))


def kernel_hierarchical_topk(torch, dev, timer, d, k, num_blocks, report):
    """approx_topk over the wave's staged ADC distance rows; also the
    share of rows on which the approximate result is the exact one."""
    from repro_torch.core.approx_topk_math import truncated_queue_len
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import ops as tk
    from repro_torch.kernels.topk import ref as tk_ref

    t0 = time.perf_counter()
    B, n = d.shape
    kp = truncated_queue_len(k, num_blocks)
    before = tk.KERNEL.launches
    dk, ik = tk.approx_topk(d, k, num_blocks=num_blocks)
    per_call = tk.KERNEL.launches - before
    dp, ip = tk_ref.ref_hierarchical_topk(d, k, num_blocks, kp)
    de, ie = tk_ref.ref_exact_topk(d, k)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
        raise AssertionError(f"hierarchical_topk differs from the plain "
                             f"version: {int((ik != ip).sum())} ids")
    if per_call != 1:
        raise AssertionError(f"hierarchical_topk: {per_call} launches a "
                             "call, not one")
    pieces = tk.topk_pieces(B, num_blocks, n // num_blocks, k,
                            _build.sm_count(dev))
    fin = torch.isfinite(dp)
    err = (dk - dp)[fin].abs().max().item() if bool(fin.any()) else 0.0
    exact_rows = ((ik == ie) & (dk == de)).all(dim=1).float().mean().item()
    ms = timer(lambda: tk.approx_topk(d, k, num_blocks=num_blocks))
    plain_ms = timer(lambda: tk_ref.ref_hierarchical_topk(d, k, num_blocks,
                                                             kp))
    lib_ms = timer(lambda: torch.topk(d, k, dim=1, largest=False))
    # the streaming yardstick: one read of the same bytes
    read_ms = timer(lambda: torch.amin(d, dim=1))
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
        torch_topk_ms=f"{lib_ms:.4f}", read_same_bytes_ms=f"{read_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", pieces_per_column_block=pieces,
        blocks=B * num_blocks * pieces, kernel_launches_per_call=per_call)


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def checked_engine(torch, dev, arch, cfg, params, ds, sizes, fused,
                   nprobe=None, rag=None, **config_kw):
    """The serve phase's engine through RalmEngine.from_config (async
    retrieval, fused or staged scan, ``nprobe`` / ``rag`` in place of the
    sizes' and the arch's, ``config_kw`` as further ``EngineConfig``
    fields), wrapped so that finiteness and id-range checks accumulate on
    the device (no syncs); ``check()`` raises if any of them failed.
    ``eng.scanned`` records the flush index of every scan its pipeline
    runs, independently of the service's counters."""
    from repro_torch.serve import EngineConfig, RalmEngine

    search_cfg = ds.search_config(nprobe=nprobe or sizes["nprobe"],
                                  k=arch.rag.k, fused=fused)
    eng = RalmEngine.from_config(
        EngineConfig(model=cfg, rag=rag or arch.rag,
                     max_seq=sizes["max_seq"], async_retrieval=True,
                     retrieval_measure=False, **config_kw),
        params, ds, search_cfg, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    n_vec = ds.num_vectors
    backend, retriever = eng.backend, eng.retriever
    prefill, decode_wave, decode, resolve = (
        backend.prefill, backend.decode_wave, backend.decode,
        retriever.resolve)

    def checked_prefill(*a, **k):
        nonlocal ok
        caches, enc_states, logits, hidden = prefill(*a, **k)
        ok = ok & torch.isfinite(logits).all()
        return caches, enc_states, logits, hidden

    def checked(step):
        def run(*a, **k):
            nonlocal ok
            logits, caches, hidden = step(*a, **k)
            ok = ok & torch.isfinite(logits).all()
            return logits, caches, hidden
        return run

    def checked_resolve(ids, kind="tokens"):
        nonlocal ok
        ok = ok & ((ids == -1) | ((ids >= 0) & (ids < n_vec))).all()
        return resolve(ids, kind)

    def check():
        if not bool(ok):
            raise AssertionError("non-finite logits or out-of-range ids")

    backend.prefill = checked_prefill
    backend.decode_wave, backend.decode = checked(decode_wave), checked(decode)
    retriever.resolve = checked_resolve
    service = retriever.service
    scan = service.pipeline.scan
    eng.scanned = []

    def counted_scan(queries):
        eng.scanned.append(service.stats.num_batches)
        return scan(queries)

    service.pipeline.scan = counted_scan
    return eng, search_cfg, check


FT_KEYS = ("ft_timeouts", "ft_hedges", "ft_retries", "ft_crashes",
           "ft_ejections", "ft_recoveries", "ft_partial_flushes",
           "ft_partial_rows")


def ft_counts(stats):
    return {k[3:]: getattr(stats, k) for k in FT_KEYS}


def drive(torch, eng, cfg, prompts, truth, steps, label,
          every_flush_scans=True, traces=False):
    """One run of the traffic, with the launch counters zeroed just
    before and read just after. Every kernel must have launched exactly
    as the engine dispatched: decode attention once per attention layer
    (none in RWKV-6) per LM step (a wave, or one request's step on the
    per-sequence loop), the IVF
    probe once per scan the pipeline ran, and the scan kernel of the
    deployment (fused scan, or adc_scan per shard) once per scan
    dispatch; no other kernel. The pipeline scans once per search flush
    (``every_flush_scans``), except under the fault-tolerant layer in a
    flush where no fault domain had a dispatch target: that flush runs
    no scan. With retrieval off (``rag.mode == "none"``) there is no
    flush and no probe or scan launch. ``traces`` records each request's
    retrieved ids per step."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import attention_layers
    from repro_torch.serve import RalmRequest

    service = eng.retriever.service
    stats, pipeline = service.stats, service.pipeline
    waves0, scans0 = eng.decode_dispatches, stats.scan_dispatches
    flushes0, batched0 = stats.num_batches, stats.batched_rows
    scanned0, strag0 = len(eng.scanned), eng.scheduler.straggler_events
    trace_lists = [[] if traces else None for _ in prompts]

    def pool_rows():
        st = eng.pool.stats if eng.pool is not None else None
        return (st.wave_rows, st.waves) if st is not None else (0, 0)

    rows0 = pool_rows()
    torch.cuda.synchronize()
    _build.reset_launches()
    t1 = time.perf_counter()
    rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=steps,
                                   trace=tr))
            for p, tr in zip(prompts, trace_lists)]
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
    scanned = eng.scanned[scanned0:]
    stragglers = eng.scheduler.straggler_events - strag0
    rows1 = pool_rows()
    wave_rows = (rows1[0] - rows0[0]) / max(rows1[1] - rows0[1], 1)
    by_id = {r.request_id: r for r in done}
    out = np.stack([by_id[r].tokens for r in rids])     # [R, B, T0 + steps]
    partial_steps = [by_id[r].partial_steps for r in rids]
    R, B = len(prompts), prompts[0].shape[0]
    gen = out[:, :, prompts[0].shape[1]:].reshape(R * B, steps)
    acc = float((gen == truth).mean())
    tokens = R * B * steps
    extra = {} if service.replicas is None else dict(
        fault=ft_counts(stats), partial_steps=partial_steps,
        flushes_without_scan=flushes - len(scanned))
    log(label, t1, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{tokens / wall:.1f}", generated_tokens=tokens,
        first_step_s=f"{t_first:.3f}",
        decode_ms_per_wave=f"{(wall - t_first) / max(waves, 1) * 1e3:.2f}",
        decode_waves=waves, mean_wave_rows=f"{wave_rows:.2f}",
        search_flushes=flushes, scan_dispatches=scans,
        coalescing=f"{(stats.batched_rows - batched0) / max(flushes, 1):.1f}",
        continuation_accuracy=f"{acc:.4f}", straggler_events=stragglers,
        launches=launches, **extra)
    scan_kernel = ("chamvs_scan_launch" if pipeline.cfg.fused
                   else "adc_scan_launch")
    want = dict.fromkeys(launches, 0)
    want.update({"decode_attn_launch": attention_layers(cfg) * waves,
                 "ivf_scan_launch": len(scanned), scan_kernel: scans})
    retrieving = eng.rag.mode != "none"
    if scans != pipeline.scan_dispatches * len(scanned) or \
            (flushes <= 0) == retrieving or \
            waves <= 0 or launches != want or \
            (every_flush_scans and len(scanned) != flushes):
        raise AssertionError(f"launches {launches} != expected {want} "
                             f"({flushes} flushes, {len(scanned)} scanned, "
                             f"{scans} scan dispatches)")
    return dict(tps=tokens / wall, acc=acc, gen=gen, launches=launches,
                rids=rids, ms_wave=(wall - t_first) / waves * 1e3,
                waves=waves,
                wall=wall, t_first=t_first, flushes=flushes,
                scanned=[f - flushes0 for f in scanned],
                partial_steps=partial_steps, stragglers=stragglers,
                traces=trace_lists)


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


def sync_run(torch, eng, cfg, prompts, truth, steps, label, fabric=None,
             traces=False):
    """One run of the traffic through a synchronous engine (no service):
    the monolithic staged engine, or the disaggregated one, whose
    retrieval runs on ``fabric``'s memory nodes. The launch counters of
    this process (and of every node) are zeroed just before and read
    just after: here decode attention once per layer per wave and, when
    monolithic, the IVF probe once per search and adc_scan once per shard
    per search; with a fabric no probe or scan here, and on each node the
    probe and adc_scan once per search it served (every node serves every
    search). Returns the tokens, rates, launches and node stats."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.serve import RalmRequest

    service = getattr(eng.retriever, "service", None)

    def searches():
        if fabric is not None:
            c = fabric.counters.get("search")
            return c.round_trips if c is not None else 0
        return service.stats.num_batches

    trace_lists = [[] if traces else None for _ in prompts]
    torch.cuda.synchronize()
    _build.reset_launches()
    if fabric is not None:
        fabric.reset()
        fabric.reset_counters()
    waves0, searches0 = eng.decode_dispatches, searches()
    times0 = None if eng.times is None else (len(eng.times.decode_s),
                                            len(eng.times.search_s))
    t1 = time.perf_counter()
    rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=steps,
                                   trace=tr))
            for p, tr in zip(prompts, trace_lists)]
    done = eng.step()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    done += eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {n: k.launches for n, k in _build.kernels().items()}
    waves = eng.decode_dispatches - waves0
    n_search = searches() - searches0
    by_id = {r.request_id: r for r in done}
    R, B = len(prompts), prompts[0].shape[0]
    gen = np.stack([by_id[r].tokens for r in rids])[
        :, :, prompts[0].shape[1]:].reshape(R * B, steps)
    acc = float((gen == truth).mean())
    want = dict.fromkeys(launches, 0)
    want["decode_attn_launch"] = cfg.n_layers * waves
    nodes = []
    if fabric is None:
        want.update(ivf_scan_launch=n_search,
                    adc_scan_launch=len(eng.retriever.shards) * n_search)
    else:
        nodes = fabric.stats()
        for node in nodes:
            node_want = dict.fromkeys(node["launches"], 0)
            node_want.update(ivf_scan_launch=n_search,
                             adc_scan_launch=n_search)
            if node["launches"] != node_want or \
                    node["searches"] != n_search:
                raise AssertionError(
                    f"{label}: node {node['pid']} launches "
                    f"{node['launches']} != {node_want} ({node['searches']} "
                    f"searches served of {n_search})")
    if launches != want or n_search <= 0:
        raise AssertionError(f"{label}: launches {launches} != {want} "
                             f"({n_search} searches)")
    extra = {}
    if times0 is not None:
        dec = eng.times.decode_s[times0[0]:]
        sea = eng.times.search_s[times0[1]:]
        extra = dict(pool_decode_ms_median=f"{median(dec) * 1e3:.3f}",
                     pool_search_ms_median=f"{median(sea) * 1e3:.3f}",
                     optimal_ratio=f"{median(dec) / median(sea):.2f}")
    log(label, t1, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{R * B * steps / wall:.1f}",
        first_step_s=f"{t_first:.3f}",
        decode_ms_per_wave=f"{(wall - t_first) / max(waves, 1) * 1e3:.2f}",
        decode_waves=waves, searches=n_search,
        continuation_accuracy=f"{acc:.4f}", launches=launches,
        node_launches=[n["launches"] for n in nodes] or None, **extra)
    return dict(tps=R * B * steps / wall, gen=gen, acc=acc, waves=waves,
                ms_wave=(wall - t_first) / max(waves, 1) * 1e3,
                searches=n_search, launches=launches, nodes=nodes,
                traces=trace_lists, extra=extra)


def card_memory_used_mb() -> int:
    """The card's used memory in MiB, every process's (nvidia-smi): the
    difference across starting the memory nodes is what they hold,
    their CUDA contexts included."""
    return int(nvidia_smi("memory.used").split()[0])


def serve_disaggregated(torch, dev, arch, cfg, params, ds, sizes, prompts,
                        truth):
    """The paper's disaggregated deployment on one card: the LM pool in
    this process and two memory-node processes (one DB shard each,
    ``EngineConfig(disaggregate=True, ret_devices=2)``), against the
    monolithic engine of the same config with synchronous retrieval and
    the staged scan, runs alternating. Tokens must be equal in every
    run; one wave's search bit-equal; each node's probe and adc_scan
    launches equal to the searches it served; no node alive after
    ``close()``."""
    import numpy as np
    from repro_torch.serve import EngineConfig, RalmEngine

    t0 = time.perf_counter()
    search_cfg = ds.search_config(nprobe=sizes["nprobe"], k=arch.rag.k,
                                  fused=False)
    config = EngineConfig(model=cfg, rag=arch.rag, max_seq=sizes["max_seq"],
                          ret_devices=ds.num_shards)
    mono = RalmEngine.from_config(config, params, ds, search_cfg, device=dev)
    torch.cuda.synchronize()
    used0 = card_memory_used_mb()
    dis = RalmEngine.from_config(
        dataclasses.replace(config, disaggregate=True), params, ds,
        search_cfg, device=dev)
    fabric = dis.retriever.router.fabric
    pids = fabric.pids
    added_mb = card_memory_used_mb() - used0
    try:
        # one wave's search (the step-0 queries) first, which also warms
        # the nodes up: bit-equal to the monolithic staged pipeline's
        q = wave_queries(torch, dev, mono, prompts, sizes)
        d_m, i_m = mono.retriever.search(q)
        d_d, i_d = dis.retriever.search(q)
        if not (torch.equal(d_m, d_d) and torch.equal(i_m, i_d)):
            raise AssertionError("one wave's disaggregated search differs "
                                 "from the monolithic staged pipeline's")
        nodes = fabric.stats()
        log("serve.disaggregated.setup", t0, memory_nodes=fabric.size,
            node_devices=list(fabric.devices), pids=pids,
            node_device_names=[n["device_name"] for n in nodes],
            node_held_gb=[f"{n['held_bytes'] / 1e9:.3f}" for n in nodes],
            card_mb_added_by_nodes=added_mb,
            placement_ms=f"{fabric.counters['place'].seconds * 1e3:.1f}",
            placement_mb=f"{fabric.counters['place'].bytes_out / 1e6:.1f}",
            wave_search_bit_equal=True, rows=q.shape[0])
        if any(n["device_name"] != torch.cuda.get_device_name(0)
               for n in nodes):
            raise AssertionError(f"nodes off the card: {nodes}")
        monos, diss = [], []
        steps = sizes["steps"]
        for _ in range(sizes["repeats"]):
            monos.append(sync_run(torch, mono, cfg, prompts, truth, steps,
                                  "serve.disaggregated.mono_run"))
            diss.append(sync_run(torch, dis, cfg, prompts, truth, steps,
                                 "serve.disaggregated.run", fabric=fabric))
        fab = {op: dict(round_trips=c.round_trips,
                        kb_out=f"{c.bytes_out / max(c.round_trips, 1) / 1e3:.1f}",
                        kb_in=f"{c.bytes_in / max(c.round_trips, 1) / 1e3:.1f}",
                        ms=f"{c.seconds / max(c.round_trips, 1) * 1e3:.3f}",
                        node_ms=f"{c.node_seconds / max(c.round_trips, 1) * 1e3:.3f}")
               for op, c in fabric.counters.items()}
        want = monos[0]["gen"]
        for r in monos + diss:
            if not np.array_equal(r["gen"], want):
                diag = sync_run(torch, dis, cfg, prompts, truth, steps,
                                "serve.disaggregated.diag", fabric=fabric,
                                traces=True)
                ref = sync_run(torch, mono, cfg, prompts, truth, steps,
                               "serve.disaggregated.diag_mono", traces=True)
                first = first_difference(diag["gen"], ref["gen"],
                                         prompts[0].shape[0])
                tr_d = diag["traces"][first["request"]][first["step"]]
                tr_m = ref["traces"][first["request"]][first["step"]]
                raise AssertionError(
                    f"disaggregated tokens differ from the monolithic "
                    f"staged engine's: {first}; retrieval ids differ "
                    f"there: {not np.array_equal(tr_d['ids'], tr_m['ids'])}")
        tps_m = sorted(r["tps"] for r in monos)
        tps_d = sorted(r["tps"] for r in diss)
        ms_m = sorted(r["ms_wave"] for r in monos)
        ms_d = sorted(r["ms_wave"] for r in diss)
        dec = sorted(float(r["extra"]["pool_decode_ms_median"]) for r in diss)
        sea = sorted(float(r["extra"]["pool_search_ms_median"]) for r in diss)
        log("serve.disaggregated.summary", t0, tokens_equal_to_mono=True,
            tokens_per_s_median=f"{median(tps_d):.1f}",
            tokens_per_s_range=f"{tps_d[0]:.1f}-{tps_d[-1]:.1f}",
            mono_tokens_per_s_median=f"{median(tps_m):.1f}",
            mono_tokens_per_s_range=f"{tps_m[0]:.1f}-{tps_m[-1]:.1f}",
            tokens_per_s_ratio=f"{median(tps_d) / median(tps_m):.3f}",
            decode_ms_per_wave_median=f"{median(ms_d):.2f}",
            mono_decode_ms_per_wave_median=f"{median(ms_m):.2f}",
            pool_decode_ms_median=f"{median(dec):.3f}",
            pool_search_ms_median=f"{median(sea):.3f}",
            optimal_ratio=f"{dis.times.optimal_ratio():.2f}",
            fabric_last_run=fab,
            node_peak_gb=[f"{n['peak_bytes'] / 1e9:.3f}"
                          for n in diss[-1]["nodes"]],
            continuation_accuracy=f"{diss[0]['acc']:.4f}")
    finally:
        dis.close()
    if any(fabric.alive()) or any(pathlib.Path(f"/proc/{p}").exists()
                                  for p in pids):
        raise AssertionError(f"memory nodes {pids} alive after close()")
    log("serve.disaggregated.closed", t0, nodes_alive=0)
    return diss[0]


def first_difference(got, want, rows):
    """(request, row, step) of the first token where ``got`` differs
    from ``want`` ([R * rows, steps] each), with the two tokens."""
    import numpy as np

    r, s = (int(x) for x in np.argwhere(got != want)[0])
    return dict(request=r // rows, row=r % rows, step=s,
                got=int(got[r, s]), want=int(want[r, s]))


def serve_spec(torch, dev, arch, cfg, params, ds, sizes, prompts, truth,
               fused_eng, fused_gen):
    """Speculative retrieval on the serve traffic: engines with
    speculate_k 1 and 2 through RalmEngine.from_config, each driven once
    (launches held to dispatches as in every run), alternating with a
    speculation-off fused run so that the rates share the call's host.
    Greedy tokens must equal the fused runs'. Returns the speculating
    runs' numbers, and the k = 1 run's as ``serve_chaos`` reports its
    run without the fault-tolerant layer."""
    import numpy as np

    t0 = time.perf_counter()
    steps, B = sizes["short_steps"], sizes["rows"]
    truth, fused_gen = truth[:, :steps], fused_gen[:, :steps]
    out, k1 = [], None
    for k in (1, 2):
        eng, _, check = checked_engine(torch, dev, arch, cfg, params, ds,
                                       sizes, fused=True, speculate_k=k)
        run = drive(torch, eng, cfg, prompts, truth, steps,
                    f"serve.spec_k{k}")
        off = drive(torch, fused_eng, cfg, prompts, truth, steps, "serve.run")
        check()
        if not np.array_equal(run["gen"], fused_gen):
            raise AssertionError(
                f"speculate_k={k}: tokens differ from the fused runs' at "
                f"{first_difference(run['gen'], fused_gen, B)}")
        st = eng.spec_stats
        if st.spec_issued <= 0 or \
                st.spec_accepted + st.spec_rollbacks != st.spec_verified:
            raise AssertionError(f"speculation counters: {st.snapshot()}")
        ms = lambda stage: (f"{stage.mean_s * 1e3:.3f}/"
                            f"{stage.max_s * 1e3:.3f}")
        row = dict(
            speculate_k=k, tokens_equal_to_fused=True,
            tokens_per_s=f"{run['tps']:.1f}",
            off_tokens_per_s=f"{off['tps']:.1f}",
            decode_ms_per_wave=(
                f"{(run['wall'] - run['t_first']) / (steps - 1) * 1e3:.2f}"),
            off_decode_ms_per_wave=f"{off['ms_wave']:.2f}",
            decode_waves=run["waves"], off_decode_waves=off["waves"],
            issued=st.spec_issued, verified=st.spec_verified,
            accepted=st.spec_accepted, rollbacks=st.spec_rollbacks,
            discarded=st.spec_discarded,
            replayed_steps=st.spec_replayed_steps,
            acceptance_rate=f"{st.spec_acceptance_rate():.4f}",
            landed_share=f"{st.spec_landed / max(st.spec_verified, 1):.4f}",
            spec_wait_ms_mean_max=ms(st.spec_wait),
            spec_replay_ms_mean_max=ms(st.spec_replay),
            rewinds=eng.pool.stats.rewinds,
            search_flushes=st.num_batches)
        log("serve.spec", t0, **row)
        out.append(row)
        if k == 1:
            k1 = spec_row(run, st)
        del eng
        torch.cuda.empty_cache()
    return out, k1


def spec_row(run, st):
    """A speculating run's rate and counters, as ``serve.chaos.spec_k1``
    logs them."""
    return dict(tps=f"{run['tps']:.1f}", landed=st.spec_landed,
                verified=st.spec_verified,
                wait_ms=f"{st.spec_wait.mean_s * 1e3:.3f}",
                replay_ms=f"{st.spec_replay.mean_s * 1e3:.3f}")


class ScanFailure(RuntimeError):
    """Raised by ``FailingPipeline``; the failure check catches only it."""


class FailingPipeline:
    """A retrieval pipeline whose scan raises, for the service's failure
    path on the card."""

    def __init__(self, k):
        self.k, self.scan_dispatches = k, 1

    def scan(self, queries):
        raise ScanFailure(f"scan of {tuple(queries.shape)} failed")


def wave_queries(torch, dev, eng, prompts, sizes):
    """One wave's 32 real query rows: the serve traffic's step-0 queries
    (the prefill's last hidden states)."""
    return torch.cat([eng.backend.prefill(
        eng.rag, torch.from_numpy(p).to(dev, torch.int32),
        sizes["max_seq"])[3] for p in prompts]).float()


def retrieval_cache(torch, dev, eng, prompts, sizes):
    """The service's result cache on the card's datastore, with one
    wave's 32 real query rows (the serve traffic's step-0 queries, from
    the prefill): a repeated batch is a full hit (no launch, bit-equal
    results); a batch whose even rows are cached sends only its odd rows
    to the scan and stitches them back (ids and distances equal to a
    cacheless service's); after a generation bump ``stale_lookup`` still
    serves the cached ids while the fresh lookup misses; and a scan that
    raises leaves handles resolving to (+inf, -1), flagged partial,
    while ``flush`` re-raises."""
    from repro_torch.kernels import _build
    from repro_torch.retrieval import RetrievalService, ServiceConfig

    t0 = time.perf_counter()
    q = wave_queries(torch, dev, eng, prompts, sizes)
    pipeline = eng.retriever.service.pipeline

    def service(**kw):
        return RetrievalService(pipeline, ServiceConfig(measure=False, **kw))

    def launches():
        return {n: kern.launches for n, kern in _build.kernels().items()}

    bare_d, bare_i = service().search(q)
    cached = service(cache_entries=256)
    d0, i0 = cached.search(q)
    before, scans0 = launches(), cached.stats.scan_dispatches
    h = cached.submit(q)
    d1, i1 = h.result()
    if not (h.done() and launches() == before and
            cached.stats.scan_dispatches == scans0 and
            torch.equal(d1, d0) and torch.equal(i1, i0) and
            d1.device == q.device and d1.dtype == torch.float32 and
            i1.dtype == torch.int32):
        raise AssertionError("a repeated batch was not a bit-equal full hit")
    half = service(cache_entries=256)
    half.search(q[0::2])
    rows0, scans0 = half.stats.batched_rows, half.stats.scan_dispatches
    h = half.submit(q)
    half.flush()
    d2, i2 = h.result()
    sent = half.stats.batched_rows - rows0
    if not (sent == q.shape[0] // 2 and
            half.stats.scan_dispatches == scans0 + 1 and
            torch.equal(i2, bare_i) and torch.equal(d2, bare_d)):
        raise AssertionError(f"half-hit batch: {sent} rows scanned, ids "
                             f"equal {torch.equal(i2, bare_i)}, dists "
                             f"equal {torch.equal(d2, bare_d)}")
    half.mark_cache_stale()
    stale = half.stale_lookup(q)
    stale0 = half.stats.cache_stale
    h = half.submit(q)
    missed = half.stats.cache_stale - stale0
    fresh_missed = not h.done()
    h.result()
    if not (stale is not None and torch.equal(stale[1], i2) and
            fresh_missed and missed == q.shape[0]):
        raise AssertionError("stale lookup / generation bump")
    failing = RetrievalService(FailingPipeline(pipeline.k),
                               ServiceConfig(measure=False))
    half_rows = q.shape[0] // 2
    handles = [failing.submit(q[:half_rows]),
               failing.submit(q[half_rows:])]
    try:
        failing.flush()
    except ScanFailure:
        pass
    else:
        raise AssertionError("flush did not re-raise the scan's failure")
    for h in handles:
        d, i = h.result()
        if not (h.partial and d.device == q.device and
                d.dtype == torch.float32 and i.dtype == torch.int32 and
                torch.isinf(d).all() and
                bool((i == -1).all())):
            raise AssertionError("failed flush: handle not (+inf, -1), "
                                 "partial, on the card")
    if failing.num_inflight:
        raise AssertionError("failed flush left entries in flight")
    log("retrieval.cache", t0, rows=q.shape[0], full_hit_launches=0,
        full_hit_bit_equal=True, half_hit_rows_scanned=sent,
        stitched_equal_to_cacheless=True, stale_ids_equal=True,
        fresh_after_bump_missed=missed, failed_flush_sentinel=True,
        failed_flush_reraised=True)


# ---------------------------------------------------------------------------
# fault tolerance and the observability plane
# ---------------------------------------------------------------------------

def write_plan(plan, name):
    """Save a FaultPlan as JSON under build/chaos/; returns its path."""
    path = ROOT / "build" / "chaos" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    plan.save(str(path))
    return str(path)


def chaos_engine(torch, dev, arch, cfg, params, ds, sizes, name, plan,
                 **config_kw):
    """A fused engine with the fault-tolerant layer armed through
    EngineConfig: two replicas per shard and ``plan`` saved as JSON."""
    return checked_engine(torch, dev, arch, cfg, params, ds, sizes,
                          fused=True, shard_replicas=2,
                          chaos_plan=write_plan(plan, name), **config_kw)


def same_tokens(label, run, want, rows):
    import numpy as np

    if not np.array_equal(run["gen"], want):
        raise AssertionError(f"{label}: tokens differ from the FT-off runs' "
                             f"at {first_difference(run['gen'], want, rows)}")


def serve_chaos(torch, dev, arch, cfg, params, ds, sizes, prompts, truth,
                fused_eng, fused_gen, staged_eng, spec_off):
    """The serve traffic with the fault-tolerant layer armed through
    EngineConfig(shard_replicas=2, chaos_plan=...) under five plans
    (none, a crashed replica, a hanging replica, a shard down, both
    shards down for a window), each engine's launches held to the
    one-scan rule by ``drive``; plus service-level checks of the partial
    and total-loss results on one wave's real queries. ``spec_off``: the
    speculating run without the layer (``serve_spec``'s k = 1 run, the
    same engine configuration), which 1b sets beside its armed run.
    Returns the crash
    engine (the untraced twin of ``obs.trace``), the armed engine without
    faults (profiled after every timed run) and the phases' rows."""
    import numpy as np
    from repro_torch.core.rag import should_retrieve
    from repro_torch.kernels import _build
    from repro_torch.retrieval import (FailoverConfig, FaultPlan, FaultSpec,
                                       RetrievalService, ServiceConfig,
                                       crash_plan, flat_merge)

    steps, B, R = sizes["steps"], sizes["rows"], sizes["requests"]
    rows = {}

    def run_plan(name, plan, **kw):
        eng, _, check = chaos_engine(torch, dev, arch, cfg, params, ds,
                                     sizes, name, plan)
        run = drive(torch, eng, cfg, prompts, truth, steps,
                    f"serve.chaos.{name}_run", **kw)
        check()
        return eng, run, eng.retriever.service.stats

    # 1. armed, no faults: the direct dispatch's tokens, every counter 0;
    #    after the engine's first run, ``repeats`` armed runs alternate
    #    with FT-off runs so that the rates share the call's host: of the
    #    long-lived fused engine and of a new one built beside the armed
    #    engine (so that engine age is not what differs)
    t0 = time.perf_counter()
    eng, first, st = run_plan("none", FaultPlan())
    fresh, _, fresh_check = checked_engine(torch, dev, arch, cfg, params, ds,
                                           sizes, fused=True)
    drive(torch, fresh, cfg, prompts, truth, steps, "serve.run")
    armed, off, fresh_off = [], [], []
    for _ in range(sizes["repeats"]):
        armed.append(drive(torch, eng, cfg, prompts, truth, steps,
                           "serve.chaos.none_run"))
        fresh_off.append(drive(torch, fresh, cfg, prompts, truth, steps,
                               "serve.run"))
        off.append(drive(torch, fused_eng, cfg, prompts, truth, steps,
                         "serve.run"))
    fresh_check()
    del fresh
    for run in [first] + armed:
        same_tokens("serve.chaos.none", run, fused_gen, B)
        if any(run["partial_steps"]):
            raise AssertionError("serve.chaos.none: partial steps")
    if any(ft_counts(st).values()):
        raise AssertionError(f"serve.chaos.none: {ft_counts(st)}")

    def spread(runs, key, digits):
        xs = sorted(r[key] for r in runs)
        return (f"{median(xs):.{digits}f} "
                f"({xs[0]:.{digits}f}-{xs[-1]:.{digits}f})")

    disp = st.ft_dispatch
    rows["none"] = dict(
        tokens_per_s=spread(armed, "tps", 1),
        ft_off_tokens_per_s=spread(off, "tps", 1),
        decode_ms_per_wave=spread(armed, "ms_wave", 2),
        ft_off_decode_ms_per_wave=spread(off, "ms_wave", 2),
        new_ft_off_tokens_per_s=spread(fresh_off, "tps", 1),
        new_ft_off_decode_ms_per_wave=spread(fresh_off, "ms_wave", 2),
        first_run_tokens_per_s=f"{first['tps']:.1f}",
        dispatch_loop_ms_mean_p50_p99=(
            f"{disp.mean_s * 1e3:.3f}/{disp.p50_s() * 1e3:.3f}/"
            f"{disp.p99_s() * 1e3:.3f}"))
    log("serve.chaos.none", t0, tokens_equal_to_ft_off=True,
        fault=ft_counts(st), **rows["none"])
    none_eng = eng

    # 1b. speculation (k=1) with the layer armed, beside speculation
    #     without it (``serve_spec``'s run): the armed flush waits for its
    #     scan, so what speculation hides is already waited for
    t0 = time.perf_counter()
    short = sizes["short_steps"]
    e, _, chk = chaos_engine(torch, dev, arch, cfg, params, ds, sizes,
                             "none_spec", FaultPlan(), speculate_k=1)
    run = drive(torch, e, cfg, prompts, truth[:, :short], short,
                "serve.chaos.spec_k1_armed")
    chk()
    same_tokens("serve.chaos.spec_k1", run, fused_gen[:, :short], B)
    rows["spec_k1"] = dict(armed=spec_row(run, e.spec_stats), off=spec_off)
    del e
    log("serve.chaos.spec_k1", t0, tokens_equal_to_ft_off=True,
        **rows["spec_k1"])

    # 2. replica 0 of shard 0 crashes on every flush: its sibling covers
    t0 = time.perf_counter()
    crash_eng, run, st = run_plan("crash", crash_plan(shard=0, replica=0))
    same_tokens("serve.chaos.crash", run, fused_gen, B)
    moved = {(t["shard"], t["replica"])
             for t in crash_eng.retriever.service.replicas.transitions}
    if not (st.ft_crashes >= 1 and st.ft_ejections == st.ft_crashes and
            moved == {(0, 0)} and st.ft_partial_flushes == 0 and
            not any(run["partial_steps"])):
        raise AssertionError(f"serve.chaos.crash: {ft_counts(st)}, "
                             f"transitions of {moved}")
    rows["crash"] = dict(tokens_per_s=f"{run['tps']:.1f}", **ft_counts(st))
    log("serve.chaos.crash", t0, tokens_equal_to_ft_off=True,
        ejected_replicas=sorted(moved), **rows["crash"])

    # 3. replica 1 of every shard hangs on half its dispatches (seeded):
    #    each hang is hedged to replica 0
    t0 = time.perf_counter()
    eng, run, st = run_plan("hang", FaultPlan.make(
        [FaultSpec(kind="hang", replica=1, p=0.5)], seed=0))
    same_tokens("serve.chaos.hang", run, fused_gen, B)
    if not (st.ft_hedges >= 1 and st.ft_partial_flushes == 0 and
            not any(run["partial_steps"])):
        raise AssertionError(f"serve.chaos.hang: {ft_counts(st)}")
    rows["hang"] = dict(tokens_per_s=f"{run['tps']:.1f}", **ft_counts(st))
    log("serve.chaos.hang", t0, tokens_equal_to_ft_off=True,
        injected=eng.retriever.service.chaos.counts(),
        replica_states=eng.retriever.service.replicas.state_counts(),
        **rows["hang"])
    del eng

    # 4. every replica of shard 1 crashes on every flush: each flush
    #    serves the exact top-k over shard 0 alone
    t0 = time.perf_counter()
    eng, run, st = run_plan("shard_down", crash_plan(shard=1, replica=-1))
    due = sum(should_retrieve(s, arch.rag.interval) for s in range(steps))
    if not (st.ft_partial_flushes == run["flushes"] and
            st.ft_partial_rows == run["flushes"] * R * B and
            run["partial_steps"] == [due] * R):
        raise AssertionError(f"serve.chaos.shard_down: {ft_counts(st)}, "
                             f"partial steps {run['partial_steps']}")
    q = wave_queries(torch, dev, fused_eng, prompts, sizes)
    k = arch.rag.k
    for deployment, other in (("fused", fused_eng), ("staged", staged_eng)):
        pipeline = other.retriever.service.pipeline
        svc = RetrievalService(pipeline, ServiceConfig(
            measure=False, failover=FailoverConfig(replicas=2)))
        svc.install_chaos(crash_plan(shard=1, replica=-1))
        h = svc.submit(q)
        svc.flush()
        d, i = h.result()
        cd, ci = pipeline.scan(q)
        rd, ri = flat_merge(cd[:1], ci[:1], k)
        torch.cuda.synchronize()
        if not (h.partial and h.live_fraction == 0.5 and d.is_cuda and
                torch.equal(i, ri) and torch.equal(d, rd)):
            raise AssertionError(
                f"shard down ({deployment}): partial {h.partial}, live "
                f"{h.live_fraction}, ids equal {torch.equal(i, ri)}, dists "
                f"bit-equal {torch.equal(d, rd)}")
    rows["shard_down"] = dict(tokens_per_s=f"{run['tps']:.1f}",
                              accuracy=f"{run['acc']:.4f}", **ft_counts(st))
    log("serve.chaos.shard_down", t0, live_fraction=0.5,
        partial_steps_per_request=due, finite_logits_ids_in_range=True,
        survivors_exact_fused_and_staged=True, rows_checked=q.shape[0],
        **rows["shard_down"])
    del eng

    # 5. both shards down for flushes 4-11: no target, no launch,
    #    (+inf, -1) on the card; later requests give the FT-off tokens
    t0 = time.perf_counter()
    eng, run, st = run_plan("loss", FaultPlan.make(
        [FaultSpec(kind="crash", start_flush=4, stop_flush=12)]),
        every_flush_scans=False, traces=True)
    scanned = set(run["scanned"])
    lost = []
    for f in range(run["flushes"]):
        ids = np.concatenate([next(e["ids"] for e in tr if e["step"] == f)
                              for tr in run["traces"]])
        if (ids == -1).all():
            lost.append(f)
    window = set(range(4, 12))
    if not (4 in scanned and not scanned & set(range(5, 12)) and
            window <= set(lost) and not set(lost) & set(range(4)) and
            set(lost) - {4} == set(range(run["flushes"])) - scanned and
            not np.any(run["gen"][:, :4] != fused_gen[:, :4])):
        raise AssertionError(f"serve.chaos.loss: scanned {sorted(scanned)}, "
                             f"lost {lost}")
    group = eng.retriever.service.replicas
    healed_in = group.cfg.probation_s - (group.clock() - max(
        h.ejected_at for h in group.health.values()))
    time.sleep(max(0.0, healed_in))          # the probation cool-off
    after = drive(torch, eng, cfg, prompts, truth, steps,
                  "serve.chaos.loss_after")
    same_tokens("serve.chaos.loss (after the window)", after, fused_gen, B)
    if any(after["partial_steps"]):
        raise AssertionError("serve.chaos.loss: partial steps after the "
                             f"window: {after['partial_steps']}")
    svc = RetrievalService(fused_eng.retriever.service.pipeline,
                           ServiceConfig(measure=False, failover=FailoverConfig(
                               replicas=2, probation_s=999.0)))
    svc.install_chaos(crash_plan(shard=-1, replica=-1))
    launched = []
    for _ in range(2):
        _build.reset_launches()
        h = svc.submit(q)
        svc.flush()
        d, i = h.result()
        torch.cuda.synchronize()
        launched.append(sum(kern.launches
                            for kern in _build.kernels().values()))
        if not (h.partial and h.live_fraction == 0.0 and d.is_cuda and
                i.is_cuda and d.dtype == torch.float32 and
                i.dtype == torch.int32 and bool(torch.isinf(d).all()) and
                bool((i == -1).all())):
            raise AssertionError("total loss: result not a (+inf, -1) "
                                 "sentinel on the card")
    if launched != [2, 0]:
        raise AssertionError(f"total loss: launches per flush {launched}, "
                             "want [2, 0] (a probe and a scan, then none)")
    rows["loss"] = dict(tokens_per_s=f"{run['tps']:.1f}",
                        flushes_lost=len(lost),
                        first_lost=lost[0], last_lost=lost[-1],
                        flushes_scanned=len(scanned), **ft_counts(st))
    log("serve.chaos.loss", t0, window="4-11", lost_flushes=lost,
        scanned_flushes_in_window=sorted(scanned & window),
        cool_off_wait_s=f"{max(0.0, healed_in):.3f}",
        tokens_after_window_equal_to_ft_off=True,
        first_4_steps_equal_to_ft_off=True,
        service_loss_launches_per_flush=launched,
        sentinel_on_card=True, **rows["loss"])
    del eng
    torch.cuda.empty_cache()
    return crash_eng, none_eng, rows


def obs_trace(torch, dev, arch, cfg, params, ds, sizes, prompts, truth,
              crash_eng, fused_gen):
    """One traced run under the crash plan through
    EngineConfig(trace=True, trace_path=build/trace/...), beside an
    untraced run of the same plan: ``write_trace`` writes the file,
    ``validate_chrome_trace`` accepts it, its retrieval.scan spans equal
    the flushes, and the tokens equal the FT-off runs'."""
    import collections
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.retrieval import crash_plan

    t0 = time.perf_counter()
    path = ROOT / "build" / "trace" / "serve_chaos_crash.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    eng, _, check = chaos_engine(torch, dev, arch, cfg, params, ds, sizes,
                                 "trace", crash_plan(shard=0, replica=0),
                                 trace=True, trace_path=str(path))
    steps = sizes["steps"]
    traced, plain = [], []
    for _ in range(2):            # traced and untraced runs alternate
        traced.append(drive(torch, eng, cfg, prompts, truth, steps,
                            "obs.trace_run"))
        plain.append(drive(torch, crash_eng, cfg, prompts, truth, steps,
                           "serve.chaos.crash_run"))
    check()
    for run in traced + plain:
        same_tokens("obs.trace", run, fused_gen, sizes["rows"])
    written = eng.write_trace()
    with open(written) as fh:
        doc = json.load(fh)
    problems = validate_chrome_trace(doc)
    names = collections.Counter(e["name"] for e in doc["traceEvents"])
    flushes = eng.retriever.service.stats.num_batches
    if problems or names["retrieval.scan"] != flushes or \
            names["wave.decode"] != eng.decode_dispatches:
        raise AssertionError(f"trace: {problems[:3]}, {dict(names)}")
    log("obs.trace", t0, path=str(path.relative_to(ROOT)), traced_runs=2,
        events=len(doc["traceEvents"]), valid=True,
        retrieval_scan_spans=names["retrieval.scan"],
        retrieval_hedge_instants=names["retrieval.hedge"],
        retrieval_eject_instants=names["retrieval.eject"],
        wave_decode_spans=names["wave.decode"],
        traced_tokens_per_s=[f"{r['tps']:.1f}" for r in traced],
        untraced_tokens_per_s=[f"{r['tps']:.1f}" for r in plain],
        traced_decode_ms_per_wave=[f"{r['ms_wave']:.2f}" for r in traced],
        untraced_decode_ms_per_wave=[f"{r['ms_wave']:.2f}" for r in plain])
    del eng


# ---------------------------------------------------------------------------
# the serving surface: degrade rungs, the per-sequence loop, the gateway
# ---------------------------------------------------------------------------

def kernel_nprobe_rungs(torch, dev, timer, ds, q, kk, rungs):
    """The IVF probe and the fused scan at the degrade ladder's nprobe
    rungs, on one wave's real queries, each held against its plain
    version (probe ids up to near-ties, as ``kernel.ivf_scan``; scan ids
    identical) and timed beside its bound. Log lines only."""
    from repro_torch.core import ivfpq
    from repro_torch.core.chamvs import stack_shards
    from repro_torch.kernels import _build
    from repro_torch.kernels.chamvs_scan import ops as cs
    from repro_torch.kernels.ivf_scan import ops as iv

    cents = ds.params.coarse_centroids
    st = stack_shards(ds.shards)
    sms = _build.sm_count(dev)
    nq, D = q.shape
    S = st.codes.shape[0]
    for nprobe in rungs:
        t0 = time.perf_counter()
        dk, ik = iv.ivf_index_scan(q, cents, nprobe)
        dp, ip = iv.ref_ivf_scan(q, cents, nprobe)
        torch.cuda.synchronize()
        mism, perr, _ = check_probe(torch, q, cents, dk, ik, dp, ip)
        probe_ms = timer(lambda: iv.ivf_index_scan(q, cents, nprobe))
        probe_bound_ms, _ = probe_bound(nq, cents.shape[0], D, nprobe)
        luts = ivfpq.compute_luts(ds.params, q, ip, ds.index_cfg)
        args = (luts, st.codes, st.ids, st.list_len, ip, kk)
        sd, si = cs.fused_scan(*args)
        p = ip.long()
        rd, ri = cs.ref_chamvs_scan(luts, st.codes[:, p], st.ids[:, p],
                                    st.list_len[:, p], kk)
        torch.cuda.synchronize()
        if not torch.equal(si, ri):
            raise AssertionError(f"fused_scan at nprobe {nprobe}: ids "
                                 f"differ in {int((si != ri).sum())}")
        fin = torch.isfinite(rd)
        serr = (sd - rd)[fin].abs().max().item() if bool(fin.any()) else 0.0
        scan_ms = timer(lambda: cs.fused_scan(*args))
        rows = float(st.list_len[:, p].double().sum())
        m, ksub = luts.shape[2], luts.shape[3]
        n_luts = nq * (1 if luts.stride(1) == 0 else nprobe)
        scan_bound_ms, scan_by = bound(
            rows * m + n_luts * m * ksub * 4 + S * nq * kk * 12, rows * m)
        groups = cs.scan_groups(S, nq, nprobe, st.codes.shape[2], kk, sms)
        log("kernel.nprobe_rungs", t0, nprobe=nprobe, nq=nq,
            probe_id_mismatch_near_ties=mism, probe_max_abs_err=f"{perr:.3e}",
            probe_ms=f"{probe_ms:.4f}", probe_bound_ms=f"{probe_bound_ms:.5f}",
            scan_ids_equal=True, scan_max_abs_err=f"{serr:.3e}",
            scan_ms=f"{scan_ms:.4f}", scan_bound_ms=f"{scan_bound_ms:.4f}",
            scan_bound_by=scan_by, scanned_rows=int(rows), scan_groups=groups,
            scan_blocks=S * nq * groups)


def kernel_decode_attn_per_seq(torch, dev, timer, cfg, sizes):
    """Decode attention as the per-sequence loop calls it: ``slots=None``
    over one request's own uncropped caches [rows, max_seq, KV, D] at the
    positions a prompt_len-token prompt reaches in ``steps`` steps; held
    against the plain version within 2^-5 of the output range (and the
    f32 oracle within 2^-8), and timed beside its bound."""
    from repro_torch.kernels.decode_attn import ops as da
    from repro_torch.kernels.decode_attn.ref import decode_validity

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(6)
    W, S = sizes["rows"], sizes["max_seq"]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lo, hi = sizes["prompt_len"], sizes["prompt_len"] + sizes["steps"] - 1
    k = torch.randn((W, S, KV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((W, S, KV, D), generator=g, device=dev).bfloat16()
    q = torch.randn((W, 1, H, D), generator=g, device=dev).bfloat16()
    pos = torch.randint(lo, hi + 1, (W,), generator=g, device=dev).int()
    out = da.decode_attention(q, k, v, pos)
    plain = da.ref_decode_attention(q, k, v, pos)
    exact = da.ref_decode_attention(q.float(), k.float(), v.float(), pos)
    torch.cuda.synchronize()
    scale = plain.float().abs().max().item()
    err = (out.float() - plain.float()).abs().max().item()
    err32 = (out.float() - exact).abs().max().item()
    tol, tol32 = 2 ** -5 * scale + 1e-3, 2 ** -8 * scale + 1e-5
    if not (err <= tol and err32 <= tol32):
        raise AssertionError(f"decode_attn per sequence: err {err} (tol "
                             f"{tol}), vs f32 {err32} (tol {tol32})")
    ms = timer(lambda: da.decode_attention(q, k, v, pos))
    plain_ms = timer(lambda: da.ref_decode_attention(q, k, v, pos))
    n_valid = int(decode_validity(pos, S, 0, False).sum())
    nbytes = 2 * n_valid * KV * D * 2 + 2 * q.numel() * 2 + W * 4
    bound_ms, bound_by = bound(nbytes, 4 * n_valid * H * D)
    log("kernel.decode_attn_per_seq", t0, shape=f"W={W},H={H},KV={KV},D={D},"
        f"S={S},slots=None", positions=f"{lo}-{hi}", max_abs_err=f"{err:.3e}",
        tol=f"{tol:.3e}", err_vs_f32=f"{err32:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
        bound_by=bound_by)


class ScoreRecorder:
    """While installed, keeps the scores (float32, on the engine's
    device) each greedy token of ``eng`` was taken from. kNN-LM at
    interval 1: the mixed log-probs, the rows of the mix that
    ``finish_wave`` / ``finish_step`` computes, in the order of the emits
    that follow it (every row is due, so the two orders agree). RETRO
    (no mix): the LM's logits that each sequence's argmax reads. A
    request gets rows when it first emits; ``rows(rids, B)`` returns
    their slabs."""

    def __init__(self, torch, eng, n_rows, steps, vocab):
        self.torch, self.eng = torch, eng
        self.scores = torch.full((n_rows, steps, vocab), float("nan"),
                                 device=eng.device)
        self.base, self.free = {}, 0
        self.pending, self.cursor, self.logits_of = None, 0, {}

    def __enter__(self):
        from repro_torch.core import rag
        eng, mix, emit = self.eng, rag.knnlm_interpolate, self.eng._emit
        self._saved = (rag, mix, eng.finish_wave, eng.finish_step, emit)

        def recording_mix(*a, **k):
            self.pending, self.cursor = mix(*a, **k), 0
            return self.pending

        def fresh(finish, wave):
            def run(*a, **k):
                self.pending = None
                # finish_wave(seqs, decoded, ...) / finish_step(seq,
                # logits, ...): the logits each sequence's argmax reads
                # when nothing is mixed into them
                self.logits_of = (
                    {id(q): lg for q, (lg, _) in zip(a[0], a[1])} if wave
                    else {id(a[0]): a[1]})
                return finish(*a, **k)
            return run

        def record(seq, rows):
            B = rows.shape[0]
            rid = seq.request.request_id
            if rid not in self.base:
                self.base[rid], self.free = self.free, self.free + B
            b = self.base[rid]
            self.scores[b:b + B, seq.step] = rows.float()

        def recording_emit(seq, nxt):
            if self.pending is not None and eng.rag.mode == "knnlm" and \
                    eng.rag.interval <= 1:
                B = nxt.shape[0]
                record(seq, self.pending[self.cursor:self.cursor + B])
                self.cursor += B
            elif eng.rag.mode == "retro" and id(seq) in self.logits_of:
                record(seq, self.logits_of[id(seq)])
            emit(seq, nxt)

        rag.knnlm_interpolate = recording_mix
        eng.finish_wave = fresh(eng.finish_wave, True)
        eng.finish_step = fresh(eng.finish_step, False)
        eng._emit = recording_emit
        return self

    def __exit__(self, *exc):
        rag, mix, finish_wave, finish_step, emit = self._saved
        rag.knnlm_interpolate = mix
        self.eng.finish_wave, self.eng.finish_step = finish_wave, finish_step
        self.eng._emit = emit
        return False

    def rows(self, rids, B):
        """[len(rids) * B, steps, V] in the order of ``rids``."""
        return self.torch.cat([self.scores[self.base[r]:self.base[r] + B]
                               for r in rids])


def near_tie_check(torch, label, gen_a, sc_a, gen_b, sc_b, rows,
                   horizon=None):
    """Two runs of the same requests at different shapes need not agree
    bit for bit, so where their greedy tokens differ this holds the
    difference to a near tie. The noise is the largest absolute
    difference of the two runs' mixed scores over every row's steps
    before its first differing token (the same inputs). At each row's
    first differing step, the gap between the two tokens' scores, in
    each run, must be within 2x that noise, and at most a quarter of the
    requests may differ. ``gen_*`` [N, steps] tokens, ``sc_*`` [N, steps,
    V] scores, ``rows`` rows per request. ``horizon`` [N] (default: all
    steps) limits each row to its first ``horizon`` steps: where the two
    runs' inputs part (a RETRO retrieval that returned other ids), later
    steps are not compared. Returns what it judged by."""
    import numpy as np

    N, T = gen_a.shape
    hz = np.full(N, T) if horizon is None else np.asarray(horizon)
    diff = (gen_a != gen_b) & (np.arange(T)[None, :] < hz[:, None])
    first = np.where(diff.any(1), diff.argmax(1), hz)
    agree = torch.from_numpy(np.arange(T)[None, :] < first[:, None]
                             ).to(sc_a.device)
    if bool(torch.isnan(sc_a[agree]).any() or
            torch.isnan(sc_b[agree]).any()):
        raise AssertionError(f"{label}: a step's scores were not recorded")
    d = torch.where(sc_a == sc_b, torch.zeros_like(sc_a), (sc_a - sc_b).abs())
    noise = float(d[agree].amax()) if bool(agree.any()) else 0.0
    n_req = N // rows
    req_differ = int(diff.reshape(n_req, rows, T).any(axis=(1, 2)).sum())
    out = dict(noise=noise, requests_differ=req_differ, requests=n_req,
               rows_differ=int(diff.any(1).sum()), worst_margin=0.0)
    for r in np.flatnonzero(first < hz):
        s = int(first[r])
        a, b = int(gen_a[r, s]), int(gen_b[r, s])
        margin = max(float(sc_a[r, s, a] - sc_a[r, s, b]),
                     float(sc_b[r, s, b] - sc_b[r, s, a]))
        out["worst_margin"] = max(out["worst_margin"], margin)
        if "first" not in out:
            out["first"] = dict(
                request=int(r) // rows, row=int(r) % rows, step=s,
                tokens=(a, b),
                run_a_scores=(float(sc_a[r, s, a]), float(sc_a[r, s, b])),
                run_b_scores=(float(sc_b[r, s, a]), float(sc_b[r, s, b])))
    if out["worst_margin"] > 2 * noise or 4 * req_differ > n_req:
        raise AssertionError(f"{label}: not a near tie: {out}")
    return out


def serve_degrade(torch, dev, arch, cfg, params, ds, sizes, prompts, truth,
                  eng, fused_gen):
    """The degrade ladder that ``DegradePolicy`` builds on the long-lived
    fused engine, rung by rung: ``policy.apply(i)`` and the serve traffic,
    whose tokens must equal those of a new engine built at the rung's
    (nprobe, interval, mode) on the same traffic (so the same wave
    shapes), with launches held to dispatches by ``drive`` (no probe or
    scan at knn-off). The baseline's pinned run is the fused runs'.
    Returns the policy, its engine back at the baseline, and the rows."""
    import dataclasses

    import numpy as np
    from repro_torch.serve import DegradePolicy

    steps, B = sizes["short_steps"], sizes["rows"]
    truth, fused_gen = truth[:, :steps], fused_gen[:, :steps]
    policy = DegradePolicy(eng)
    rows = []
    for i, rung in enumerate(policy.ladder):
        t0 = time.perf_counter()
        policy.apply(i)
        name = rung_label(rung)
        run = drive(torch, eng, cfg, prompts, truth, steps,
                    f"serve.degrade.{name}_run")
        pinned_tps = None
        want = fused_gen
        if i:
            rag = dataclasses.replace(arch.rag, interval=rung.interval,
                                      mode="knnlm" if rung.knn else "none")
            pinned, _, check = checked_engine(torch, dev, arch, cfg, params,
                                              ds, sizes, fused=True,
                                              nprobe=rung.nprobe, rag=rag)
            prun = drive(torch, pinned, cfg, prompts, truth, steps,
                         f"serve.degrade.{name}_pinned")
            check()
            want, pinned_tps = prun["gen"], f"{prun['tps']:.1f}"
            del pinned
        if not np.array_equal(run["gen"], want):
            raise AssertionError(
                f"serve.degrade.{name}: tokens differ from the pinned "
                f"engine's at {first_difference(run['gen'], want, B)}")
        row = dict(rung=rung.name, nprobe=rung.nprobe,
                   interval=rung.interval, knn=rung.knn,
                   tokens_per_s=f"{run['tps']:.1f}",
                   pinned_tokens_per_s=pinned_tps,
                   decode_ms_per_wave=f"{run['ms_wave']:.2f}",
                   accuracy=f"{run['acc']:.4f}", search_flushes=run["flushes"],
                   probe_launches=run["launches"]["ivf_scan_launch"],
                   scan_launches=run["launches"]["chamvs_scan_launch"])
        rows.append(row)
        log(f"serve.degrade.{name}", t0, tokens_equal_to_pinned=True, **row)
    policy.apply(0)
    torch.cuda.empty_cache()
    return policy, rows


def rung_label(rung):
    return rung.name.replace(" ", "_").replace("/", "_")


def serve_per_sequence(torch, dev, arch, cfg, params, ds, sizes, prompts,
                       truth, rag=None, label="serve.per_sequence"):
    """The per-sequence loop (``EngineConfig(wave_decode=False)``) on the
    first ``per_seq_requests`` requests of the serve traffic, beside a
    wave run of the same requests (at ``rag``, the arch's by default);
    decode attention must launch n_layers x (steps - 1) x requests
    times; tokens are held to the wave run's by ``near_tie_check`` (each
    request decodes alone at its own width here, in one wave there).
    Also reports the first (request, step) whose retrieved ids differ
    between the two runs. Returns its launch counts."""
    import numpy as np

    t0 = time.perf_counter()
    R, B, steps = sizes["per_seq_requests"], sizes["rows"], sizes["steps"]
    prompts, truth = prompts[:R], truth[:R * B, :steps]
    runs, scores = {}, {}
    for name, wave in (("wave", True), ("per_sequence", False)):
        e, _, check = checked_engine(torch, dev, arch, cfg, params, ds, sizes,
                                     fused=True, rag=rag, wave_decode=wave)
        with ScoreRecorder(torch, e, R * B, steps, cfg.vocab_size) as rec:
            runs[name] = drive(torch, e, cfg, prompts, truth, steps,
                               f"{label}.{name}_run", traces=True)
        check()
        scores[name] = rec.rows(runs[name]["rids"], B)
        del e, rec
    per, wave = runs["per_sequence"], runs["wave"]
    want = cfg.n_layers * (steps - 1) * R
    if per["launches"]["decode_attn_launch"] != want:
        raise AssertionError(f"per-sequence decode attention launched "
                             f"{per['launches']['decode_attn_launch']} "
                             f"times, not {want}")
    # the first step at which each request's retrieved ids differ between
    # the two runs (None: never). Under RETRO the chunks of a retrieval
    # at step r shape the logits from step r + 1 on, so where the ids
    # part the runs condition on other inputs: each row is compared up to
    # that step (horizon). Step 0's query comes from the same prefill in
    # both runs, so its ids must be equal.
    ids_differ = []
    for ta, tb in zip(per["traces"], wave["traces"]):
        by_step = {e["step"]: e["ids"] for e in tb}
        ids_differ.append(next(
            (e["step"] for e in sorted(ta, key=lambda e: e["step"])
             if not np.array_equal(e["ids"], by_step.get(e["step"]))), None))
    horizon = None
    if (rag or arch.rag).mode == "retro":
        if 0 in ids_differ:
            raise AssertionError(f"{label}: step 0's retrieval differs "
                                 f"between the runs: {ids_differ}")
        horizon = np.repeat([steps if r is None else r + 1
                             for r in ids_differ], B)
    tie = near_tie_check(torch, label, per["gen"], scores["per_sequence"],
                         wave["gen"], scores["wave"], B, horizon=horizon)
    log(label, t0, requests=R, rows=B, steps=steps,
        retrieval_ids_differ_from_step=ids_differ,
        rows_equal=int((per["gen"] == wave["gen"]).all(1).sum()),
        tokens_per_s=f"{per['tps']:.1f}",
        wave_tokens_per_s=f"{wave['tps']:.1f}",
        decode_ms_per_request_step=f"{per['ms_wave']:.2f}",
        wave_decode_ms_per_wave=f"{wave['ms_wave']:.2f}",
        decode_attn_launches=per["launches"]["decode_attn_launch"],
        accuracy=f"{per['acc']:.4f}", wave_accuracy=f"{wave['acc']:.4f}",
        near_tie=tie)
    del scores
    torch.cuda.empty_cache()
    return per["launches"]


def sse_client(port, prompt, steps, out, key, disconnect_after=None,
               timeout_s=300.0):
    """One streaming POST /v1/completions on a raw socket: records the
    status, the tokens, each token's arrival time, the final chunk, the
    request id and the send time under ``out[key]``; with
    ``disconnect_after`` it closes the socket after that many tokens."""
    body = json.dumps({"prompt": prompt, "max_tokens": steps,
                       "stream": True}).encode()
    head = (f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    res = dict(status=None, tokens=[], stamps=[], final=None, rid=None,
               done=False, t_send=time.perf_counter())
    out[key] = res
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout_s)
    try:
        s.sendall(head + body)
        buf = b""
        while b"\r\n\r\n" not in buf:
            data = s.recv(65536)
            if not data:
                return
            buf += data
        status_line, buf = buf.split(b"\r\n\r\n", 1)
        res["status"] = int(status_line.split(b"\r\n")[0].split()[1])
        if res["status"] != 200:
            return
        while True:
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                now = time.perf_counter()
                if event == b"data: [DONE]":
                    res["done"] = True
                    return
                obj = json.loads(event[6:])
                res["rid"] = int(obj["id"].split("-")[1])
                choice = obj["choices"][0]
                if choice["finish_reason"] is not None:
                    res["final"] = obj
                    continue
                res["tokens"] += [int(t) for t in choice["text"].split()]
                res["stamps"].append(now)
                if disconnect_after is not None and \
                        len(res["tokens"]) >= disconnect_after:
                    return
            data = s.recv(65536)
            if not data:
                return
            buf += data
    finally:
        s.close()


def run_clients(port, jobs, timeout_s=300.0):
    """One thread per (key, prompt, steps, disconnect_after) job, all
    started together and joined; returns the results by key and the wall
    time from the first start to the last join."""
    out = {}
    threads = [threading.Thread(target=sse_client,
                                args=(port, p, n, out, key, cut, timeout_s),
                                daemon=True)
               for key, p, n, cut in jobs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a gateway client did not finish in "
                             f"{timeout_s} s")
    return out, time.perf_counter() - t0


def pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=float), q))


def latencies(results):
    """Server-side (the final chunk's RequestTiming) and client-side
    (socket arrival) TTFT and TPOT in ms, per completed request."""
    srv_ttft = [r["final"]["ralm"]["ttft_ms"] for r in results]
    srv_tpot = [r["final"]["ralm"]["tpot_ms"] for r in results]
    cli_ttft = [(r["stamps"][0] - r["t_send"]) * 1e3 for r in results]
    cli_tpot = [(r["stamps"][-1] - r["stamps"][0]) * 1e3 /
                max(len(r["stamps"]) - 1, 1) for r in results]
    return srv_ttft, srv_tpot, cli_ttft, cli_tpot


def gateway_launch_check(eng, cfg, before, label):
    """Launches since ``before`` (the engine's counters when the launch
    counts were zeroed) against the engine's own counts: decode attention
    n_layers per wave, the probe and the fused scan one per flush."""
    from repro_torch.kernels import _build

    stats = eng.retriever.service.stats
    launches = {n: k.launches for n, k in _build.kernels().items()}
    waves = eng.decode_dispatches - before["waves"]
    flushes = stats.num_batches - before["flushes"]
    want = dict.fromkeys(launches, 0)
    want.update({"decode_attn_launch": cfg.n_layers * waves,
                 "ivf_scan_launch": flushes, "chamvs_scan_launch": flushes})
    if launches != want or flushes <= 0:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    return launches, waves, flushes


def serve_gateway(torch, dev, arch, cfg, params, ds, sizes, corpus):
    """The HTTP gateway on the card, over a fused engine with a fixed pool
    (``kv_slots``) and the default degrade ladder, started with
    ``start_background()``: one streaming client (``gateway.single``),
    one client per corpus prompt at once (``gateway.load``), twice as many
    clients as slots (``gateway.overload``), and a client that walks away
    after two tokens (``gateway.cancel``). Every in-process reference
    runs on its own engine of the same config before the gateway starts:
    this thread launches no kernel while the gateway's step thread runs.
    Returns the phases' rows."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.serve import Gateway, GatewayConfig

    T0, steps, slots = sizes["prompt_len"], sizes["steps"], sizes["kv_slots"]
    n = sizes["requests"] * sizes["rows"]
    prompts = [corpus[i, :T0] for i in range(n)]
    truth = corpus[:n, T0:T0 + steps]
    kw = dict(fused=True, kv_slots=slots)

    # -- in-process references, before the gateway starts ------------------
    t0 = time.perf_counter()
    ref, _, ref_check = checked_engine(torch, dev, arch, cfg, params, ds,
                                       sizes, **kw)
    single_want = ref.generate(torch.from_numpy(prompts[0][None]),
                               steps)[0, T0:]
    cancel_want = ref.generate(torch.from_numpy(prompts[5][None]),
                               sizes["cancel_steps"])[0, T0:]
    with ScoreRecorder(torch, ref, n, steps, cfg.vocab_size) as rec:
        offline = drive(torch, ref, cfg, [p[None] for p in prompts], truth,
                        steps, "gateway.load_offline")
    ref_check()
    off_scores = rec.rows(offline["rids"], 1)
    del ref, rec
    log("gateway.references", t0, offline_tokens_per_s=f"{offline['tps']:.1f}",
        offline_accuracy=f"{offline['acc']:.4f}")

    eng, _, check = checked_engine(torch, dev, arch, cfg, params, ds, sizes,
                                   **kw)
    recorder = ScoreRecorder(torch, eng, n, steps, cfg.vocab_size)
    card = nvidia_smi()
    gw = Gateway(eng, GatewayConfig())
    gw.start_background()
    stats = eng.retriever.service.stats
    rows = {}

    def counters():
        return dict(waves=eng.decode_dispatches, flushes=stats.num_batches)

    try:
        # -- gateway.single -------------------------------------------------
        t0 = time.perf_counter()
        _build.reset_launches()
        before = counters()
        res, wall = run_clients(gw.port, [(0, prompts[0].tolist(), steps,
                                           None)])
        r = res[0]
        same = np.array_equal(r["tokens"], single_want)
        if not (r["status"] == 200 and r["done"] and same):
            raise AssertionError(f"gateway.single: status {r['status']}, "
                                 f"tokens equal {same}")
        launches, waves, flushes = gateway_launch_check(eng, cfg, before,
                                                        "gateway.single")
        st, sp, ct, cp = latencies([r])
        rows["single"] = dict(server_ttft_ms=f"{st[0]:.2f}",
                              server_tpot_ms=f"{sp[0]:.3f}",
                              client_ttft_ms=f"{ct[0]:.2f}",
                              client_tpot_ms=f"{cp[0]:.3f}",
                              tokens_per_s=f"{steps / wall:.1f}")
        log("gateway.single", t0, card=card, prompt_len=T0, steps=steps,
            tokens_equal_to_in_process=True, decode_waves=waves,
            search_flushes=flushes, launches=launches, **rows["single"])

        # -- gateway.load ---------------------------------------------------
        t0 = time.perf_counter()
        _build.reset_launches()
        before = counters()
        down0 = gw.policy.transitions_down
        with recorder:
            res, wall = run_clients(gw.port, [(i, prompts[i].tolist(), steps,
                                               None) for i in range(n)])
        done = [res[i] for i in range(n)]
        if not all(r["status"] == 200 and r["done"] and
                   len(r["tokens"]) == steps for r in done):
            raise AssertionError("gateway.load: a request did not complete: "
                                 + str([(r["status"], len(r["tokens"]),
                                         r["done"]) for r in done]))
        launches, waves, flushes = gateway_launch_check(eng, cfg, before,
                                                        "gateway.load")
        if eng.pool.num_used != 0:
            raise AssertionError(f"gateway.load: {eng.pool.num_used} slots "
                                 "still in use")
        gen = np.array([r["tokens"] for r in done])
        levels = [tuple(r["final"]["ralm"]["degrade_levels"]) for r in done]
        base = [i for i, lv in enumerate(levels) if lv == (0,)]
        if 4 * len(base) < 3 * n:
            raise AssertionError(f"gateway.load: only {len(base)} of {n} "
                                 "requests ran at the baseline level")
        got_scores = recorder.rows([done[i]["rid"] for i in base], 1)
        tie = near_tie_check(torch, "gateway.load", gen[base], got_scores,
                             offline["gen"][base], off_scores[base], 1)
        del got_scores, off_scores
        st, sp, ct, cp = latencies(done)
        rows["load"] = dict(
            clients=n, tokens_per_s=f"{n * steps / wall:.1f}",
            server_ttft_ms_p50_p95=f"{pct(st, 50):.1f}/{pct(st, 95):.1f}",
            server_tpot_ms_p50_p95=f"{pct(sp, 50):.2f}/{pct(sp, 95):.2f}",
            client_ttft_ms_p50_p95=f"{pct(ct, 50):.1f}/{pct(ct, 95):.1f}",
            client_tpot_ms_p50_p95=f"{pct(cp, 50):.2f}/{pct(cp, 95):.2f}",
            degrade_levels_seen=sorted({x for lv in levels for x in lv}),
            transitions_down=gw.policy.transitions_down - down0,
            accuracy=f"{float((gen == truth).mean()):.4f}",
            offline_accuracy=f"{offline['acc']:.4f}",
            offline_tokens_per_s=f"{offline['tps']:.1f}")
        log("gateway.load", t0, card=card, decode_waves=waves,
            search_flushes=flushes,
            mean_wave_rows=f"{n * (steps - 1) / max(waves, 1):.2f}",
            launches=launches, compared_at_baseline=len(base), near_tie=tie,
            **rows["load"])
        rows["load"]["launches"] = launches

        # -- gateway.overload -----------------------------------------------
        t0 = time.perf_counter()
        over = 2 * slots
        down0, up0 = gw.policy.transitions_down, gw.policy.transitions_up
        done0 = gw.completions
        res, wall = run_clients(gw.port, [
            (i, prompts[i % n].tolist(), steps, None) for i in range(over)])
        status = [res[i]["status"] for i in range(over)]
        admitted = [res[i] for i in range(over) if status[i] == 200]
        if not all(r["done"] and len(r["tokens"]) == steps
                   for r in admitted):
            raise AssertionError("gateway.overload: an admitted request did "
                                 "not complete")
        deadline = time.perf_counter() + 60
        while gw.policy.level != 0 and time.perf_counter() < deadline:
            time.sleep(0.05)
        if gw.policy.transitions_down - down0 < 1 or gw.policy.level != 0:
            raise AssertionError(
                f"gateway.overload: {gw.policy.transitions_down - down0} "
                f"steps down, level {gw.policy.level} after the drain")
        if eng.pool.num_used != 0:
            raise AssertionError("gateway.overload: slots still in use")
        st, sp, _, _ = latencies(admitted)
        rows["overload"] = dict(
            clients=over, admitted=len(admitted),
            rejected_503=status.count(503),
            other_status=sorted({s for s in status if s not in (200, 503)}),
            transitions_down=gw.policy.transitions_down - down0,
            transitions_up=gw.policy.transitions_up - up0,
            deepest_rung=max(h["level"] for h in gw.policy.history),
            completions=gw.completions - done0,
            tokens_per_s=f"{len(admitted) * steps / wall:.1f}",
            server_ttft_ms_p50_p95=f"{pct(st, 50):.1f}/{pct(st, 95):.1f}",
            server_tpot_ms_p50_p95=f"{pct(sp, 50):.2f}/{pct(sp, 95):.2f}")
        log("gateway.overload", t0, card=card, recovered_to_level=0,
            history=[(h["level"], h["queue_depth"])
                     for h in gw.policy.history], **rows["overload"])

        # -- gateway.cancel -------------------------------------------------
        t0 = time.perf_counter()
        gone0 = gw.disconnects
        res, _ = run_clients(gw.port, [(0, prompts[3].tolist(), steps, 2)])
        deadline = time.perf_counter() + 30
        while (gw.disconnects == gone0 or eng.pool.num_used or
               gw.scheduler.num_active) and time.perf_counter() < deadline:
            time.sleep(0.01)
        if not (res[0]["status"] == 200 and gw.disconnects - gone0 == 1 and
                eng.pool.num_used == 0):
            raise AssertionError(f"gateway.cancel: disconnects "
                                 f"{gw.disconnects - gone0}, slots in use "
                                 f"{eng.pool.num_used}")
        res, _ = run_clients(gw.port, [(0, prompts[5].tolist(),
                                        sizes["cancel_steps"], None)])
        if not np.array_equal(res[0]["tokens"], cancel_want):
            raise AssertionError("gateway.cancel: the following request's "
                                 "tokens differ from its solo run")
        rows["cancel"] = dict(disconnects=gw.disconnects - gone0,
                              cancelled=gw.cancelled, slots_in_use=0)
        log("gateway.cancel", t0, following_tokens_equal_to_solo=True,
            **rows["cancel"])
    finally:
        gw.shutdown()
    check()
    del eng, gw, recorder
    torch.cuda.empty_cache()
    return rows


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
    that ran on the card (kernels, copies) over the window's wall time;
    host sync ms = the host's time inside CUDA synchronize calls."""
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
    averages = prof.key_averages()
    dev = [e for e in averages
           if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0)), e.count,
                   e.key) for e in dev)[::-1]
    busy_us = sum(r[0] for r in rows)
    syncs = [e for e in averages
             if e.device_type == torch.autograd.DeviceType.CPU and
             "Synchronize" in e.key]
    log(label, t0, decode_waves=steps - 1,
        wall_ms=f"{wall * 1e3:.1f}", device_busy_ms=f"{busy_us / 1e3:.1f}",
        host_sync_ms=f"{sum(e.self_cpu_time_total for e in syncs) / 1e3:.1f}",
        host_syncs=sum(e.count for e in syncs),
        device_ms_per_wave=f"{busy_us / 1e3 / (steps - 1):.3f}",
        device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        device_events=len(rows))
    for us, count, key in rows[:12]:
        print(f"  device {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}",
              flush=True)


def run_phases(torch, dev, sizes):
    """Set-up, the kernel phases, the serve phases and the search tools
    of Dec-S on ``dev`` at ``sizes``; returns the kernel report rows by
    kernel name, and the weights and index (left on the card) that the
    step-builder phase reuses."""
    from repro_torch.serve import DegradePolicy

    arch, cfg, params, corpus, keys, ds = setup(dev, sizes)

    timer = Timer(torch)
    report = {}
    queries = kernel_queries(torch, dev, keys, sizes)
    kernel_decode_attn(torch, dev, timer, cfg, sizes, report)
    probe_ids = kernel_ivf_scan(torch, dev, timer, ds, queries, sizes, report)
    kernel_ivf_scan_nlist32768(torch, dev, timer, sizes)
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
    disagg = serve_disaggregated(torch, dev, arch, cfg, params, ds, sizes,
                                 prompts, truth)
    _, spec_k1 = serve_spec(torch, dev, arch, cfg, params, ds, sizes,
                            prompts, truth, eng, runs[0]["gen"])
    retrieval_cache(torch, dev, eng, prompts, sizes)
    crash_eng, none_eng, _ = serve_chaos(torch, dev, arch, cfg, params, ds,
                                         sizes, prompts, truth, eng,
                                         runs[0]["gen"], staged_eng, spec_k1)
    obs_trace(torch, dev, arch, cfg, params, ds, sizes, prompts, truth,
              crash_eng, runs[0]["gen"])
    del crash_eng
    torch.cuda.empty_cache()
    # the serving surface: the kernels at the degrade rungs' and the
    # per-sequence loop's shapes, the ladder, the loop, the gateway
    q = wave_queries(torch, dev, eng, prompts, sizes)
    rungs = {r.nprobe for r in DegradePolicy(eng).ladder} - {sizes["nprobe"]}
    kernel_nprobe_rungs(torch, dev, timer, ds, q, kk,
                        sorted(rungs, reverse=True))
    kernel_decode_attn_per_seq(torch, dev, timer, cfg, sizes)
    del q
    policy, _ = serve_degrade(torch, dev, arch, cfg, params, ds, sizes,
                              prompts, truth, eng, runs[0]["gen"])
    per_seq = serve_per_sequence(torch, dev, arch, cfg, params, ds, sizes,
                                 prompts, truth)
    gateway = serve_gateway(torch, dev, arch, cfg, params, ds, sizes, corpus)
    # after every timed serve run: a profiled window leaves the profiler's
    # hooks behind, which slows the host side of later waves
    sampled_request(torch, eng, prompts[0], cfg.vocab_size, steps=16)
    # 7 decode waves each (the profiler's processing takes ~1 s a wave;
    # 15 waves took 17-19 s a profile)
    profile_waves(torch, eng, prompts, steps=8)
    profile_waves(torch, staged_eng, prompts, steps=8,
                  label="serve.staged_profile")
    profile_waves(torch, none_eng, prompts, steps=8,
                  label="serve.chaos_none_profile")
    del staged_eng, none_eng
    for i, rung in enumerate(policy.ladder):      # device ms a wave per rung
        policy.apply(i)
        profile_waves(torch, eng, prompts, steps=4,
                      label=f"serve.degrade_profile.{rung_label(rung)}")
    policy.apply(0)
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
    for name, sym in (("ivf_scan", "ivf_scan_launch"),
                      ("adc_scan", "adc_scan_launch")):
        report[name].update(
            launches_nodes=[n["launches"][sym] for n in disagg["nodes"]],
            launches_nodes_in="serve.disaggregated (each memory node)")
    report["decode_attn"].update(
        launches_disaggregated=disagg["launches"]["decode_attn_launch"],
        launches_disaggregated_in="serve.disaggregated (the LM pool)")
    report["decode_attn"].update(
        launches_per_sequence=per_seq["decode_attn_launch"],
        launches_per_sequence_in="serve.per_sequence")
    for name, sym in (("decode_attn", "decode_attn_launch"),
                      ("ivf_scan", "ivf_scan_launch"),
                      ("fused_scan", "chamvs_scan_launch")):
        report[name].update(
            launches_gateway=gateway["load"]["launches"][sym],
            launches_gateway_in="gateway.load")
    # the search tools while the keys are on the card; the step-builder
    # phase, after training, reuses the weights and the index, which stay
    # on the card (~0.6 GB), not the 8.6 GB of keys
    search_tools(torch, dev, arch, sizes, keys, queries, ds, nvidia_smi())
    kept = dict(arch=arch, sizes=sizes, corpus=corpus, params=params, ds=ds)
    return report, kept


# ---------------------------------------------------------------------------
# the paper's other three RALMs: Dec-L, EncDec-S, EncDec-L
# ---------------------------------------------------------------------------

# The reference's ModelConfig.param_count() of each full config (the
# weight matrices and embeddings; the port's count adds the norms).
REFERENCE_PARAMS = {"dec_l": 1260732416, "encdec_s": 132661248,
                    "encdec_l": 1688584192,
                    "seamless_m4t_medium": 977694720}
# The index each model serves from: SYN-1024's shapes at d_model 1024
# (m 64), SYN-512's at 512 (m 32); the corpus is Dec-S's (cut to
# ``n_docs``), the traffic Dec-S's. RETRO models run at each interval
# listed (the paper's densest, 8, and EncDec-S's registered 64). The
# kernels run at Dec-L's new shapes (16 KV heads, D 1024, m 64) once.
# Cuts for the script's time: Dec-L's corpus is 512 docs (262 144 keys,
# 2048 before; its 4 194 304 keys over all 8192 took ~174 s on an H100
# 80GB HBM3 at 700 W; the prompts and truth are the first 32 docs, which
# every cut keeps), the RETRO models' 2048 (1 048 576 keys: on smaller
# corpora their per-sequence twins parted from their wave runs in more
# requests than the near-tie rule's quarter, EncDec-S at 512 docs,
# EncDec-L at 1024), the profiles cover profile_steps - 1 waves
# (no retrieval in a RETRO window: steps 1-2), and the per-sequence twin
# (``twin`` overrides the sizes) runs 4 requests, so that the near-tie
# rule's quarter admits one, EncDec-L's for 16 steps (two retrievals).
# Every model generates ``short_steps`` tokens a row (EncDec-L's four
# runs of 64 took 66.8 s), Dec-L runs ``n_layers`` 24 of its 96 layers
# (its phase took 66.7 s at 96, 25.4-27.2 s at 48) and EncDec-L 72 of
# its 96 decoder layers (125.9-135.4 s at 96, 62.3-65.9 s at 48), for
# the script's time.
PAPER = (("dec_l", dict(m=64, n_docs=512, intervals=(1,), kernels=True,
                        profile_steps=4, n_layers=24)),
         ("encdec_s", dict(m=32, n_docs=2048, intervals=(8, 64),
                           profile_steps=3,
                           twin=dict(per_seq_requests=4))),
         ("encdec_l", dict(m=64, n_docs=2048, intervals=(8,),
                           profile_steps=3, n_layers=72,
                           twin=dict(per_seq_requests=4, steps=16))))
# The seeded cross-attention is too weak for retrieval to move a greedy
# token; xwv and xwo are scaled by this factor so that it does (the
# reduced CPU recipe needs 40; at full width 40 makes the cross-attention
# the largest term of the residual stream).
RETRO_XSCALE = 40.0


def n_tensor_params(tree):
    if isinstance(tree, dict):
        return sum(n_tensor_params(v) for v in tree.values())
    if isinstance(tree, tuple):            # the hybrid's MambaParams
        return sum(n_tensor_params(v) for v in tree)
    return tree.numel()


def n_tensor_bytes(tree):
    if isinstance(tree, dict):
        return sum(n_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(n_tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def chunk_table(torch, corpus, chunk_len):
    """RETRO payload: row i = the ``chunk_len`` tokens after key i's
    position in its document (key i is document i // (doc_len - 1),
    position i % (doc_len - 1), as ``corpus_keys`` orders them), PAD 0
    past the document's end. ``corpus`` [n, doc_len] int32 on the card."""
    n, L = corpus.shape
    padded = torch.cat([corpus, corpus.new_zeros((n, chunk_len))], dim=1)
    idx = (torch.arange(L - 1, device=corpus.device)[:, None] + 1 +
           torch.arange(chunk_len, device=corpus.device)[None, :])
    return padded[:, idx].reshape(n * (L - 1), chunk_len)


def paper_setup(torch, dev, name, opts, sizes, corpus):
    """Seeded weights at full width and depth, the model's own keys over
    the corpus (an encoder-decoder's decoder alone, without encoder
    states), the chunk table (RETRO) and the IVF-PQ datastore; returns
    (arch, cfg, params, ds, queries): 32 keys plus noise for the kernel
    phases."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    arch = get_arch(name)
    cfg = arch.model
    if "n_layers" in opts:                  # a depth cut (listed in PERF.md)
        cfg = dataclasses.replace(cfg, n_layers=opts["n_layers"])
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    retro = arch.rag.mode == "retro"
    if retro:
        for leaf in ("xwv", "xwo"):
            params["classes"]["global"][leaf] *= RETRO_XSCALE
    log(f"paper.{name}.params", t0, layers=cfg.n_layers,
        enc_layers=cfg.n_enc_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype=cfg.dtype,
        tensor_params=n_tensor_params(params),
        reference_param_count=REFERENCE_PARAMS[name],
        rag=arch.rag, xwv_xwo_scale=RETRO_XSCALE if retro else 1.0)
    keys, ds = build_index(
        torch, dev, f"paper.{name}", cfg, params,
        np.ascontiguousarray(corpus[:opts["n_docs"]]), sizes, opts["m"],
        chunk_len=arch.rag.chunk_len if retro else None)
    queries = kernel_queries(torch, dev, keys, sizes)
    del keys
    torch.cuda.empty_cache()
    return arch, cfg, params, ds, queries


def paper_kernels(torch, dev, timer, name, cfg, arch, ds, queries, sizes,
                  report):
    """The kernels at this model's shapes (decode attention at its heads,
    the IVF probe at its width, the fused scan and adc_scan at its m),
    each against its plain version and timed beside its bound; the
    numbers join the kernel's report row under ``_<name>`` keys."""
    sub = {}
    kernel_decode_attn(torch, dev, timer, cfg, sizes, sub,
                       label=f"paper.{name}.kernel.decode_attn")
    probe_ids = kernel_ivf_scan(torch, dev, timer, ds, queries, sizes, sub,
                                label=f"paper.{name}.kernel.ivf_scan")
    kk = ds.search_config(nprobe=sizes["nprobe"],
                          k=arch.rag.k).k_prime(ds.num_shards)
    kernel_fused_scan(torch, dev, timer, ds, queries, probe_ids, kk, sub,
                      label=f"paper.{name}.kernel.fused_scan")
    kernel_adc_scan(torch, dev, timer, ds, queries, probe_ids, kk, sub,
                    label=f"paper.{name}.kernel.adc_scan")
    merge_rows(report, sub, name)
    torch.cuda.empty_cache()


def merge_rows(report, sub, name):
    """A model's kernel rows into the report's: every measured key under
    ``<key>_<name>``."""
    for kernel, row in sub.items():
        for key, value in row.items():
            if key not in ("name", "route", "source", "replaces"):
                report[kernel][f"{key}_{name}"] = value


def plain_run(torch, eng, cfg, prompts, steps, label):
    """The traffic through an engine without a retriever (no retrieval,
    no probe or scan launch), decode attention launched once per layer
    per wave; returns the generated tokens [R * rows, steps]."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import attention_layers
    from repro_torch.serve import RalmRequest

    torch.cuda.synchronize()
    _build.reset_launches()
    waves0 = eng.decode_dispatches
    t1 = time.perf_counter()
    rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=steps))
            for p in prompts]
    by_id = {r.request_id: r.tokens for r in eng.run()}
    torch.cuda.synchronize()
    waves = eng.decode_dispatches - waves0
    launches = {n: k.launches for n, k in _build.kernels().items()}
    want = dict.fromkeys(launches, 0)
    want["decode_attn_launch"] = attention_layers(cfg) * waves
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    log(label, t1, decode_waves=waves, launches=launches)
    R, B = len(prompts), prompts[0].shape[0]
    return np.stack([by_id[r] for r in rids])[:, :, prompts[0].shape[1]:
                                              ].reshape(R * B, steps)


def paper_serve(torch, dev, name, opts, arch, cfg, params, ds, sizes,
                corpus):
    """The serve traffic through ``name``: fused runs (``repeats`` for
    the kNN-LM, one a RETRO interval), a staged run whose tokens must
    equal them, and a profile of ``opts["profile_steps"] - 1`` decode
    waves (at the first interval). A RETRO model also runs without
    retrieval once (``mode="none"``, and with its RETRO widths but no
    retriever): the share of tokens that retrieval changed must be > 0 at
    every interval; and its per-sequence twin runs at the first interval
    (``opts["twin"]`` overrides the sizes). Returns the launch counts of
    the first interval's fused and staged runs (and the twin's)."""
    import dataclasses

    import numpy as np
    from repro_torch.serve import RalmEngine

    R, B, T0 = sizes["requests"], sizes["rows"], sizes["prompt_len"]
    steps = sizes["steps"]
    prompts = [corpus[r * B:(r + 1) * B, :T0] for r in range(R)]
    truth = corpus[:R * B, T0:T0 + steps]
    retro = arch.rag.mode == "retro"
    launches, baselines = {}, None
    for iv in opts["intervals"]:
        t0 = time.perf_counter()
        first = iv == opts["intervals"][0]
        rag = dataclasses.replace(arch.rag, interval=iv)
        tag = f"paper.{name}" + (f".interval{iv}" if retro else "")
        eng, _, check = checked_engine(torch, dev, arch, cfg, params, ds,
                                       sizes, fused=True, rag=rag)
        runs = [drive(torch, eng, cfg, prompts, truth, steps, f"{tag}.run")
                for _ in range(1 if retro else sizes["repeats"])]
        staged_eng, _, check_s = checked_engine(
            torch, dev, arch, cfg, params, ds, sizes, fused=False, rag=rag)
        staged = drive(torch, staged_eng, cfg, prompts, truth, steps,
                       f"{tag}.staged")
        check()
        check_s()
        del staged_eng
        if not all(np.array_equal(r["gen"], runs[0]["gen"])
                   for r in runs + [staged]):
            raise AssertionError(f"{tag}: staged or repeated tokens differ "
                                 "from the first fused run's")
        run = runs[0]
        tps = sorted(r["tps"] for r in runs)
        extra = {}
        if retro:
            if not run["flushes"] < run["waves"]:
                raise AssertionError(f"{tag}: {run['flushes']} flushes, not "
                                     f"fewer than {run['waves']} waves")
            if baselines is None:
                none_eng, _, check_n = checked_engine(
                    torch, dev, arch, cfg, params, ds, sizes, fused=True,
                    rag=dataclasses.replace(rag, mode="none"))
                none = drive(torch, none_eng, cfg, prompts, truth, steps,
                             f"paper.{name}.mode_none")
                check_n()
                del none_eng
                bare = RalmEngine.monolithic(params, cfg, rag, retriever=None,
                                             max_seq=sizes["max_seq"])
                baselines = dict(
                    mode_none=none["gen"],
                    no_retriever=plain_run(torch, bare, cfg, prompts, steps,
                                           f"paper.{name}.no_retriever"))
                del bare
            for base, gen in baselines.items():
                share = float((run["gen"] != gen).mean())
                extra[f"differ_from_{base}"] = f"{share:.4f}"
                if share <= 0.0:
                    raise AssertionError(f"{tag}: retrieval moved no token "
                                         f"against the {base} run")
            extra["enc_buffer"] = tuple(eng.pool.enc.shape)
        log(f"{tag}.summary", t0, tokens_per_s_median=f"{median(tps):.1f}",
            tokens_per_s_range=f"{tps[0]:.1f}-{tps[-1]:.1f}",
            decode_ms_per_wave=f"{median([r['ms_wave'] for r in runs]):.2f}",
            decode_waves=run["waves"], search_flushes=run["flushes"],
            continuation_accuracy=f"{run['acc']:.4f}",
            staged_tokens_equal=True,
            staged_tokens_per_s=f"{staged['tps']:.1f}",
            launches=run["launches"], staged_launches=staged["launches"],
            **extra)
        if first:
            launches = dict(fused=run["launches"], staged=staged["launches"])
            profile_waves(torch, eng, prompts, steps=opts["profile_steps"],
                          label=f"{tag}.profile")
        del eng
        torch.cuda.empty_cache()
    if retro and opts.get("twin") is not None:
        rag = dataclasses.replace(arch.rag, interval=opts["intervals"][0])
        launches["per_sequence"] = serve_per_sequence(
            torch, dev, arch, cfg, params, ds, dict(sizes, **opts["twin"]),
            prompts, truth, rag=rag, label=f"paper.{name}.per_sequence")
    return launches


def paper_phases(torch, dev, sizes, report):
    """Dec-L, EncDec-S and EncDec-L at full width and depth, one after
    the other (each model's engines and index freed before the next);
    their launch counts join the report rows of the kernels they run."""
    sizes = dict(sizes, steps=sizes["short_steps"])
    import gc

    import numpy as np

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, 50000, size=(sizes["n_docs"], sizes["doc_len"]),
                          dtype=np.int32)
    for name, opts in PAPER:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        arch, cfg, params, ds, queries = paper_setup(torch, dev, name, opts,
                                                     sizes, corpus)
        if opts.get("kernels"):
            paper_kernels(torch, dev, timer, name, cfg, arch, ds, queries,
                          sizes, report)
        counts = paper_serve(torch, dev, name, opts, arch, cfg, params, ds,
                             sizes, corpus)
        for kernel, sym, run in (
                ("decode_attn", "decode_attn_launch", "fused"),
                ("ivf_scan", "ivf_scan_launch", "fused"),
                ("fused_scan", "chamvs_scan_launch", "fused"),
                ("adc_scan", "adc_scan_launch", "staged")):
            report[kernel][f"launches_{name}"] = counts[run][sym]
        if "per_sequence" in counts:
            report["decode_attn"][f"launches_per_sequence_{name}"] = \
                counts["per_sequence"]["decode_attn_launch"]
        log(f"paper.{name}", t0,
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del arch, cfg, params, ds, queries
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the dense assigned backbones: Qwen2-0.5B, Phi-3-mini, Gemma-3-4B served
# at full width; Llama-3-405B's and Qwen2-VL-72B's head layouts
# ---------------------------------------------------------------------------

# The reference's ModelConfig.param_count() of each full config.
ASSIGNED_PARAMS = {"qwen2_0_5b": 493961216, "phi3_mini_3_8b": 3820879872,
                   "gemma3_4b": 3879731200, "hymba_1_5b": 1391875200,
                   "rwkv6_3b": 3114270720,
                   # at the 16 layers served (41 872 261 120 at 32)
                   "phi3_5_moe_42b": 21067464704}
# Each model serves Dec-S's traffic shape (8 requests x 4 rows, 32
# greedy tokens: ``short_steps``) from its own keys over its own seeded
# corpus (tokens
# below its vocab and below Dec-S's 50 000), indexed at the reference's
# default m = d_model // 16 (56, 192, 160: the scans' generic path).
# Cuts for the script's time: the corpora (qwen2 1024 docs, phi3 512,
# gemma3 256: 524 288, 262 144 and 282 624 keys; twice as many before).
# Gemma-3's prompts are
# 1040 tokens, so that its local layers' 1024-slot rings wrap in prefill
# and again in decode; its documents are 1105 tokens (prompt + 64 steps
# + 1).
ASSIGNED_SERVED = (
    ("qwen2_0_5b", dict(m=56, n_docs=1024)),
    ("phi3_mini_3_8b", dict(m=192, n_docs=512)),
    ("gemma3_4b", dict(m=160, n_docs=256, doc_len=1105, prompt_len=1040,
                       max_seq=1104, ring_wraps=True)),
)
# The two backbones that do not fit the card (810 GB and 144 GB of bf16
# weights): decode attention at their full head layouts on a seeded
# pool at Dec-S's serve shape (W 32, 512 slots); no model.
HEAD_LAYOUTS = (("llama3_405b", 128, 8, 128), ("qwen2_vl_72b", 64, 8, 128))


def decode_row(torch, dev, timer, label, seed, W, P, H, KV, D, S, window,
               ring, pos_lo, pos_hi, kv_len):
    """One decode-attention shape checked (``decode_case``) and timed
    (``decode_timed``); returns its measured numbers."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn import ops as da

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    c = decode_case(torch, dev, g, W, P, H, KV, D, S, window, ring, pos_lo,
                    pos_hi, kv_len)
    t = decode_timed(torch, dev, timer, c)
    S_read = kv_len or S
    split = da.pick_split(W, KV, S_read, _build.sm_count(dev), None,
                          da.resident_blocks(D, H // KV))
    decode_log(label, t0, c, t, W, P, split,
               blocks=W * KV * -(-S_read // split))
    return dict(max_abs_err=c["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=t["library_ms"])


def assigned_heads(torch, dev, timer, sizes, report):
    """Llama-3-405B's (128:8) and Qwen2-VL-72B's (64:8) head layouts at
    D 128: decode attention on a seeded pool, positions over the serve's
    generation window; the rows join the decode_attn report row."""
    W = sizes["requests"] * sizes["rows"]
    S = sizes["max_seq"]
    for i, (name, H, KV, D) in enumerate(HEAD_LAYOUTS):
        row = decode_row(torch, dev, timer,
                         f"assigned.{name}.kernel.decode_attn", 80 + i, W,
                         W + 1, H, KV, D, S, 0, False, sizes["prompt_len"],
                         S - 1, S)
        merge_rows(report, {"decode_attn": row}, name)


def assigned_setup(torch, dev, name, sizes):
    """Seeded weights at full width and depth, a seeded corpus below the
    model's vocab, its keys and the IVF-PQ datastore; returns (arch,
    cfg, params, corpus, ds, queries)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    arch = get_arch(name)
    cfg = arch.model
    if "n_layers" in sizes:                 # a depth cut (listed in PERF.md)
        cfg = dataclasses.replace(cfg, n_layers=sizes["n_layers"])
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, min(cfg.vocab_size, 50000),
                          size=(sizes["n_docs"], sizes["doc_len"]),
                          dtype=np.int32)
    log(f"assigned.{name}.params", t0, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        layer_pattern=",".join(cfg.layer_pattern), window=cfg.window,
        qkv_bias=cfg.qkv_bias, tied=cfg.tie_embeddings, dtype=cfg.dtype,
        block=cfg.block, experts=cfg.n_experts, top_k=cfg.top_k,
        ssm_state=cfg.ssm_state, rope_mode=cfg.rope_mode,
        tensor_params=n_tensor_params(params),
        reference_param_count=ASSIGNED_PARAMS[name],
        weight_bytes=n_tensor_bytes(params), rag=arch.rag)
    keys, ds = build_index(torch, dev, f"assigned.{name}", cfg, params,
                           corpus, sizes, sizes["m"])
    queries = kernel_queries(torch, dev, keys, sizes)
    del keys
    torch.cuda.empty_cache()
    return arch, cfg, params, corpus, ds, queries


def assigned_kernels(torch, dev, timer, name, cfg, arch, ds, queries, sizes,
                     report):
    """The kernels at this model's shapes (decode attention at its heads
    over its serve pool, Gemma-3's local ring of 1024 slots too; the IVF
    probe at its width; the fused scan and adc_scan at its m), each
    against its plain version and timed; the rows join the report's
    under ``_<name>`` keys."""
    from repro_torch.models.transformer import attention_layers

    sub = {}
    if attention_layers(cfg):
        kernel_decode_attn(torch, dev, timer, cfg, sizes, sub,
                           label=f"assigned.{name}.kernel.decode_attn")
    if cfg.window:
        W = sizes["requests"] * sizes["rows"]
        T0, S = sizes["prompt_len"], sizes["max_seq"]
        ring = decode_row(
            torch, dev, timer, f"assigned.{name}.kernel.decode_attn_ring",
            90, W, W + 1, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            cfg.window, cfg.window, True, T0, S - 1, None)
        sub["decode_attn"].update(
            {f"{k}_ring": v for k, v in ring.items()})
    probe_ids = kernel_ivf_scan(torch, dev, timer, ds, queries, sizes, sub,
                                label=f"assigned.{name}.kernel.ivf_scan")
    kk = ds.search_config(nprobe=sizes["nprobe"],
                          k=arch.rag.k).k_prime(ds.num_shards)
    kernel_fused_scan(torch, dev, timer, ds, queries, probe_ids, kk, sub,
                      label=f"assigned.{name}.kernel.fused_scan")
    kernel_adc_scan(torch, dev, timer, ds, queries, probe_ids, kk, sub,
                    label=f"assigned.{name}.kernel.adc_scan")
    merge_rows(report, sub, name)
    torch.cuda.empty_cache()


def assigned_serve(torch, dev, name, arch, cfg, params, corpus, ds, sizes):
    """The serve traffic through ``name``: one fused run and one staged
    run whose tokens must equal it (launches held to the dispatches by
    ``drive``), a profile of 3 decode waves, and the prefill's peak
    memory (one request's 4 rows; ``forward`` returns the prompt's
    [4, T0, vocab] logits). Gemma-3's local rings must be shorter than
    the prompt where ``sizes["ring_wraps"]`` says so (they wrap).
    Returns the fused and staged launch counts."""
    import numpy as np

    R, B, T0 = sizes["requests"], sizes["rows"], sizes["prompt_len"]
    steps = sizes["steps"]
    prompts = [corpus[r * B:(r + 1) * B, :T0] for r in range(R)]
    truth = corpus[:R * B, T0:T0 + steps]
    t0 = time.perf_counter()
    eng, search_cfg, check = checked_engine(torch, dev, arch, cfg, params,
                                            ds, sizes, fused=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_pre = time.perf_counter()
    eng.backend.prefill(arch.rag, torch.from_numpy(prompts[0]).to(dev),
                        sizes["max_seq"])
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t_pre) * 1e3
    prefill_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    run = drive(torch, eng, cfg, prompts, truth, steps,
                f"assigned.{name}.run")
    staged_eng, _, check_s = checked_engine(torch, dev, arch, cfg, params,
                                            ds, sizes, fused=False)
    staged = drive(torch, staged_eng, cfg, prompts, truth, steps,
                   f"assigned.{name}.staged")
    check()
    check_s()
    del staged_eng
    if not np.array_equal(staged["gen"], run["gen"]):
        raise AssertionError(f"assigned.{name}: staged tokens differ from "
                             "the fused run's")
    extra = {}
    if cfg.window:
        ring = eng.pool.caches["classes"]["local"]["k"].shape[2]
        wraps = ring == cfg.window < T0
        if sizes.get("ring_wraps") and not wraps:
            raise AssertionError(f"assigned.{name}: local ring of {ring} "
                                 f"slots does not wrap under {T0}-token "
                                 "prompts")
        extra = dict(local_ring_slots=ring, ring_wraps_in_prefill=wraps)
    log(f"assigned.{name}.summary", t0,
        tokens_per_s=f"{run['tps']:.1f}",
        decode_ms_per_wave=f"{run['ms_wave']:.2f}",
        decode_waves=run["waves"], search_flushes=run["flushes"],
        continuation_accuracy=f"{run['acc']:.4f}",
        staged_tokens_equal=True, staged_tokens_per_s=f"{staged['tps']:.1f}",
        staged_decode_ms_per_wave=f"{staged['ms_wave']:.2f}",
        launches=run["launches"], staged_launches=staged["launches"],
        prompt_len=T0, m=ds.index_cfg.m, nprobe=search_cfg.nprobe,
        prefill_ms_4_rows=f"{prefill_ms:.1f}",
        prefill_peak_gb_4_rows=f"{prefill_gb:.2f}",
        weight_read_bound_ms=f"{n_tensor_bytes(params) / HBM_BYTES_PER_S * 1e3:.3f}",
        **extra)
    profile_waves(torch, eng, prompts, steps=4,
                  label=f"assigned.{name}.profile")
    del eng
    torch.cuda.empty_cache()
    return dict(fused=run["launches"], staged=staged["launches"])


def assigned_phases(torch, dev, sizes, report):
    """The head layouts of the two backbones that do not fit the card,
    then Qwen2-0.5B, Phi-3-mini and Gemma-3-4B at full width and depth,
    one after the other (each model freed before the next)."""
    sizes = dict(sizes, steps=sizes["short_steps"])
    import gc

    timer = Timer(torch)
    assigned_heads(torch, dev, timer, sizes, report)
    for name, over in ASSIGNED_SERVED:
        t0 = time.perf_counter()
        msizes = dict(sizes, **over)
        torch.cuda.reset_peak_memory_stats()
        arch, cfg, params, corpus, ds, queries = assigned_setup(
            torch, dev, name, msizes)
        assigned_kernels(torch, dev, timer, name, cfg, arch, ds, queries,
                         msizes, report)
        counts = assigned_serve(torch, dev, name, arch, cfg, params, corpus,
                                ds, msizes)
        for kernel, sym, run in (
                ("decode_attn", "decode_attn_launch", "fused"),
                ("ivf_scan", "ivf_scan_launch", "fused"),
                ("fused_scan", "chamvs_scan_launch", "fused"),
                ("adc_scan", "adc_scan_launch", "staged")):
            report[kernel][f"launches_{name}"] = counts[run][sym]
        log(f"assigned.{name}", t0,
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del arch, cfg, params, corpus, ds, queries
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the non-dense assigned backbones: Hymba-1.5B, RWKV-6-3B and Phi-3.5-MoE
# served at full width, SeamlessM4T-medium through RETRO; DBRX-132B's head
# layout and one full-width MoE layer
# ---------------------------------------------------------------------------

# Dec-S's traffic shape again, each model on its own seeded corpus,
# m = d_model // 16 (Phi-3.5-MoE's 256: a 256 KB LUT, over the 227 KB of
# shared memory a block may hold, which the scans then read from global
# memory). Cuts: Phi-3.5-MoE's depth 16 of 32 layers (32 are ~84 GB of
# bf16 weights, over the 80 GB card); the corpora (Hymba 512
# docs, 262 144 keys; RWKV-6 256 docs of 544 tokens, 139 008 keys: 544
# is 17 chunks of 32, so the keys' forward takes the chunked time mix,
# 512 docs took 22.4 s of keys; Phi-3.5-MoE 512 docs, 262 144 keys;
# SeamlessM4T 1024 docs, 524 288 keys), and Hymba's depth, 16 of 32
# layers (one whole cycle of its layer pattern: its Python Mamba loop made
# the phase 69-70 s at 32). The kNN-LM keys of Hymba run its Mamba loop,
# 128 documents a batch.
NONDENSE_SERVED = (
    ("hymba_1_5b", dict(m=100, n_docs=512, key_batch=128, n_layers=16)),
    ("rwkv6_3b", dict(m=160, n_docs=256, doc_len=544)),
    ("phi3_5_moe_42b", dict(m=256, n_docs=512, n_layers=16)),
)
# SeamlessM4T-medium: a dense RETRO encoder-decoder (12 + 12 layers, 16:16
# heads of 64, vocab 256 206) at its registered interval 64, K 10, chunks
# of 64; its decode-attention shape is Dec-L's (16:16, D 64, timed there).
SEAMLESS = (("seamless_m4t_medium", dict(m=64, n_docs=1024, intervals=(64,),
                                         profile_steps=4)),)
# DBRX-132B (~264 GB of bf16 weights) does not fit: its decode attention
# at 48:8 D 128 (G 6) on a seeded pool at the serve shape, and one of its
# MoE FFN layers at full width (d 6144, 16 experts of d_ff 10 752, top-4;
# 6.3 GB) on a W-32 wave (None skips them).
DBRX = "dbrx_132b"


def dbrx_phases(torch, dev, timer, sizes, report):
    """DBRX's head layout (decode attention against its plain version and
    timed) and one full-width MoE FFN layer: two runs bit-equal, timed
    against the bytes of its expert weights."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    cfg = get_arch(DBRX).model
    W, S = sizes["requests"] * sizes["rows"], sizes["max_seq"]
    row = decode_row(torch, dev, timer, f"assigned.{DBRX}.kernel.decode_attn",
                     88, W, W + 1, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, S,
                     0, False, sizes["prompt_len"], S - 1, S)
    merge_rows(report, {"decode_attn": row}, DBRX)

    t0 = time.perf_counter()
    E, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k
    g = torch.Generator(device=dev).manual_seed(8)

    def w(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype) * 0.02
    router = w(d, E, dtype=torch.float32)
    wg, wu, wd = w(E, d, f), w(E, d, f), w(E, f, d)
    x = torch.randn((W, d), generator=g, device=dev, dtype=torch.bfloat16)
    a = moe.moe_ffn(x, router, wg, wu, wd, k, act=cfg.act)
    b = moe.moe_ffn(x, router, wg, wu, wd, k, act=cfg.act)
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and bool(torch.isfinite(a).all())):
        raise AssertionError("dbrx moe_ffn: two runs differ or not finite")
    _, ids = moe.route_topk(x, router, k)
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    C = moe.capacity(W, E, k)
    ms = timer(lambda: moe.moe_ffn(x, router, wg, wu, wd, k, act=cfg.act))
    nbytes = 3 * E * d * f * 2 + d * E * 4
    bound_ms, bound_by = bound(nbytes, 0.0)
    log(f"assigned.{DBRX}.moe_layer", t0, W=W, d=d, experts=E, d_ff=f,
        top_k=k, capacity=C, experts_hit=int((counts > 0).sum()),
        dropped=int((counts - C).clamp(min=0).sum()),
        expert_bytes=nbytes, ms=f"{ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, tb_s=f"{nbytes / ms / 1e9:.3f}",
        bit_equal_runs=True)
    del wg, wu, wd
    torch.cuda.empty_cache()


def nondense_phases(torch, dev, sizes, report):
    """DBRX's head layout and MoE layer; Hymba-1.5B, RWKV-6-3B and
    Phi-3.5-MoE (16 layers) at full width, one after the other, each with
    its own corpus and index, the kernels at its shapes and the serve
    traffic fused and staged; then SeamlessM4T-medium through RETRO
    (``paper_setup`` / ``paper_serve``: fused, staged, without retrieval,
    the share of tokens retrieval moves)."""
    sizes = dict(sizes, steps=sizes["short_steps"])
    import gc

    import numpy as np
    from repro_torch.configs import get_arch

    timer = Timer(torch)
    if DBRX:
        dbrx_phases(torch, dev, timer, sizes, report)
    for name, over in NONDENSE_SERVED:
        t0 = time.perf_counter()
        msizes = dict(sizes, **over)
        torch.cuda.reset_peak_memory_stats()
        arch, cfg, params, corpus, ds, queries = assigned_setup(
            torch, dev, name, msizes)
        assigned_kernels(torch, dev, timer, name, cfg, arch, ds, queries,
                         msizes, report)
        counts = assigned_serve(torch, dev, name, arch, cfg, params, corpus,
                                ds, msizes)
        for kernel, sym, run in (
                ("decode_attn", "decode_attn_launch", "fused"),
                ("ivf_scan", "ivf_scan_launch", "fused"),
                ("fused_scan", "chamvs_scan_launch", "fused"),
                ("adc_scan", "adc_scan_launch", "staged")):
            report[kernel][f"launches_{name}"] = counts[run][sym]
        log(f"assigned.{name}", t0,
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del arch, cfg, params, corpus, ds, queries
        gc.collect()
        torch.cuda.empty_cache()
    for name, opts in SEAMLESS:
        t0 = time.perf_counter()
        vocab = get_arch(name).model.vocab_size
        corpus = np.random.default_rng(0).integers(
            0, min(vocab, 50000), size=(sizes["n_docs"], sizes["doc_len"]),
            dtype=np.int32)
        torch.cuda.reset_peak_memory_stats()
        arch, cfg, params, ds, queries = paper_setup(torch, dev, name, opts,
                                                     sizes, corpus)
        counts = paper_serve(torch, dev, name, opts, arch, cfg, params, ds,
                             sizes, corpus)
        for kernel, sym, run in (
                ("decode_attn", "decode_attn_launch", "fused"),
                ("ivf_scan", "ivf_scan_launch", "fused"),
                ("fused_scan", "chamvs_scan_launch", "fused"),
                ("adc_scan", "adc_scan_launch", "staged")):
            report[kernel][f"launches_{name}"] = counts[run][sym]
        log(f"assigned.{name}", t0,
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del arch, cfg, params, ds, queries
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training: Dec-S at full width (straight, crash and resume), EncDec-S's
# RETRO example, two data-parallel ranks on the card, the FA2 backward
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12              # H100 SXM bf16 dense, tensor cores
# 20 steps, crashed after step 10 and resumed from its checkpoint (cut
# for the script's time from 30 steps crashed after 20)
TRAIN_DEC_S = dict(seq_len=512, batch=16, microbatches=2, steps=20,
                   ckpt_every=5, fail_at=10, windows=400, lr=1e-3,
                   warmup=5)
TRAIN_RETRO_STEPS = 8            # examples.train_retro --full, cut from 200
TRAIN_DP = dict(ranks=2, steps=3, seq_len=512, batch=8)
TRAIN_TP = dict(data=2, model=2, steps=3, seq_len=512, batch=8)
#: the training phases that run (tools/model_phases.py narrows them)
TRAIN_PHASES = ("dec_s", "encdec_s", "dp", "tp", "flash_attn")
FLASH_SHAPES = (   # name, B, T, S, H, KV, causal: the training shapes
    ("dec_s", 8, 512, 512, 8, 8, True),            # a micro-batch of 8
    ("encdec_s.cross", 64, 512, 640, 8, 8, False),
    ("encdec_s.encoder", 64, 640, 640, 8, 8, False))


def train_corpus(n_tokens: int, n_ids: int = 1024, seed: int = 0):
    """A seeded first-order Markov chain over ``n_ids`` token ids (each
    id's successor one of 4 fixed ids), so that a model can learn it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    succ = rng.integers(0, n_ids, size=(n_ids, 4))
    pick = rng.integers(0, 4, size=n_tokens)
    toks = np.zeros(n_tokens, np.int32)
    for i in range(1, n_tokens):
        toks[i] = succ[toks[i - 1], pick[i]]
    return toks


def train_root():
    import shutil
    root = ROOT / "build" / "train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    return root


def step_stats(durations, tokens, n_params):
    """Median, min and max step ms, tokens/s at the median, and the share
    of the bf16 dense peak that 6 x N x tokens a step reaches."""
    ms = sorted(d * 1e3 for d in durations)
    med = median(ms)
    return dict(step_ms_median=f"{med:.2f}", step_ms_min=f"{ms[0]:.2f}",
                step_ms_max=f"{ms[-1]:.2f}",
                tokens_per_s=f"{tokens / med * 1e3:.0f}",
                bf16_peak_share=f"{6 * n_params * tokens / (med / 1e3) / BF16_FLOPS:.4f}")


def train_dec_s(torch, dev, root, card):
    """Dec-S at full width from seeded weights on a seeded Markov corpus
    (MemmapTokens): a straight run, then the same run crashed after step
    ``fail_at`` and resumed from its checkpoint, every loss bit-equal."""
    import math

    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, MemmapTokens
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import (SimulatedFailure,
                                                     TrainController)

    o = TRAIN_DEC_S
    t0 = time.perf_counter()
    cfg = get_arch("dec_s").model
    MemmapTokens.write_corpus(root / "corpus.bin", train_corpus(
        o["windows"] * o["seq_len"] + 1, min(1024, cfg.vocab_size)))
    data = MemmapTokens(root / "corpus.bin", DataConfig(
        seq_len=o["seq_len"], global_batch=o["batch"],
        vocab_size=cfg.vocab_size))
    ocfg = adamw.AdamWConfig(lr=o["lr"], warmup_steps=o["warmup"],
                             total_steps=o["steps"])
    step = build_train_step(cfg, ocfg, remat=True,
                            microbatches=o["microbatches"])

    def fresh():
        p = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        return p, adamw.init_opt_state(p, ocfg)

    torch.cuda.reset_peak_memory_stats()
    straight = TrainController(step, data, root / "straight",
                               ckpt_every=o["ckpt_every"])
    params, opt = straight.run(*fresh(), total_steps=o["steps"])
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in straight.metrics_log]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train.dec_s: losses {losses}")
    tc = time.perf_counter()
    ckpt.save(root / "sync", o["steps"], (params, opt))
    ck_ms = (time.perf_counter() - tc) * 1e3
    ck_bytes = sum(t.numel() * t.element_size()
                   for t in tree_lib.leaves((params, opt)))
    n = cfg.param_count()
    log("train.dec_s", t0, card=f"'{card}'", params_m=f"{n / 1e6:.2f}",
        seq=o["seq_len"], batch=o["batch"],
        microbatches=o["microbatches"], remat=True, steps=o["steps"],
        timed_steps=f"5-{o['steps']}",
        **step_stats(straight.monitor.durations[5:],
                     o["batch"] * o["seq_len"], n),
        peak_mem_gb=f"{peak / 1e9:.2f}", ckpt_write_ms=f"{ck_ms:.1f}",
        ckpt_mb=f"{ck_bytes / 1e6:.1f}", loss_first=f"{losses[0]:.4f}",
        loss_last=f"{losses[-1]:.4f}")
    print("  losses " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    del params, opt

    t0 = time.perf_counter()
    resumed = TrainController(step, data, root / "resume",
                              ckpt_every=o["ckpt_every"])
    resumed.fail_at = o["fail_at"]
    try:
        resumed.run(*fresh(), total_steps=o["steps"])
    except SimulatedFailure:
        pass
    else:
        raise AssertionError("train.dec_s.resume: no failure was injected")
    resumed.run(*fresh(), total_steps=o["steps"])
    got = {m["step"]: m["loss"] for m in resumed.metrics_log}
    differ = [s for s in range(o["steps"]) if got.get(s) != losses[s]]
    if differ:
        s = differ[0]
        raise AssertionError(
            f"train.dec_s.resume: loss of step {s} {got.get(s)!r} != "
            f"{losses[s]!r} ({len(differ)} steps differ)")
    log("train.dec_s.resume", t0, fail_at=o["fail_at"],
        resumed_from=o["fail_at"], steps=o["steps"],
        losses_bit_equal=o["steps"])


def train_encdec_s(torch, dev, root, card):
    """``examples.train_retro --full`` (EncDec-S, Table 2, seq 512, batch
    64, 640 encoder rows), steps cut to ``TRAIN_RETRO_STEPS``; the
    example raises if the loss did not fall."""
    from repro_torch.configs import get_arch
    from repro_torch.examples import train_retro

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ctl = train_retro.main(["--full", "--steps", str(TRAIN_RETRO_STEPS),
                            "--ckpt-dir", str(root / "retro"),
                            "--device", dev.type])
    losses = [m["loss"] for m in ctl.metrics_log]
    cfg = get_arch("encdec_s").model
    log("train.encdec_s", t0, card=f"'{card}'",
        params_m=f"{cfg.param_count() / 1e6:.2f}", seq=512, batch=64,
        enc_len=640, steps=TRAIN_RETRO_STEPS, timed_steps=f"2-{TRAIN_RETRO_STEPS}",
        **step_stats(ctl.monitor.durations[2:], 64 * 512,
                     cfg.param_count()),
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}")


def train_dp(torch, dev, root, card):
    """Dec-S at full width on two ranks sharing the card (gloo, staged
    through host memory) for ``steps`` steps and one more from the
    checkpoint: each step's loss within 1e-3 of a one-rank run of the
    same global batch in this process, and step ``steps + 1`` resumed on
    one rank (``elastic_restore``) within 1e-3 of the two ranks'."""
    from repro_torch.launch import dp, train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.runtime.fault_tolerance import elastic_restore

    o = TRAIN_DP
    t0 = time.perf_counter()
    args = ["--arch", "dec_s", "--seq-len", str(o["seq_len"]),
            "--batch", str(o["batch"]), "--steps", str(o["steps"] + 1),
            "--ckpt-every", str(o["steps"]), "--ckpt-dir", str(root / "dp"),
            "--device", dev.type]
    lines = dp.launch(o["ranks"], "repro_torch.launch.train:run", args,
                      device=dev.type, timeout_s=600)
    ranks = {m["step"]: m for m in (json.loads(ln.split(" ", 3)[3])
                                    for ln in lines
                                    if ln.startswith("[train] step "))}
    t_ranks = time.perf_counter() - t0
    ns = train.parser().parse_args(args)
    cfg, ocfg, params, opt, data = train.build(ns, dev)
    step = build_train_step(cfg, ocfg)

    def batch(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.host_batch(s).items()}
    gaps = []
    for s in range(o["steps"]):
        params, opt, m = step(params, opt, batch(s))
        gaps.append(abs(float(m["loss"]) - ranks[s]["loss"]))
    (params, opt), at = elastic_restore(root / "dp", (params, opt),
                                        dp.Group.single(dev), step=o["steps"])
    _, _, m = step(params, opt, batch(o["steps"]))
    gaps.append(abs(float(m["loss"]) - ranks[o["steps"]]["loss"]))
    if not max(gaps) < 1e-3:
        raise AssertionError(f"train.dp: loss gaps {gaps} (bound 1e-3)")
    ar = [ranks[s]["allreduce_ms"] for s in sorted(ranks)]
    log("train.dp", t0, card=f"'{card}'", ranks=o["ranks"],
        backend=dp.backend_for(dev.type, o["ranks"]), seq=o["seq_len"],
        global_batch=o["batch"], steps=len(ranks), resumed_at=at,
        ranks_s=f"{t_ranks:.1f}",
        loss_gaps=",".join(f"{g:.2e}" for g in gaps),
        allreduce_mb=f"{ranks[0]['allreduce_bytes'] / 1e6:.1f}",
        allreduce_ms=",".join(f"{x:.1f}" for x in ar))


def train_tp(torch, dev, root, card):
    """Dec-S at full width on a ``data x model`` mesh of ranks sharing the
    card (gloo, staged through host memory), each holding its shards of
    the parameters and moments (``launch.steps``' sharded step), for
    ``steps`` steps and one more from the checkpoint (whole leaves): each
    step's loss within 1e-3 of a one-rank run of the same global batch in
    this process, step ``steps + 1`` resumed on one rank
    (``elastic_restore``) within 1e-3 of the mesh's, and every rank's
    resident parameter and moment bytes equal to the dry run's count for
    one device of the mesh. Logs step ms and each axis's collective MB
    and ms a step."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import dp, dryrun, train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.steps import build_train_step
    from repro_torch.runtime.fault_tolerance import elastic_restore

    o = TRAIN_TP
    D, M = o["data"], o["model"]
    t0 = time.perf_counter()
    args = ["--arch", "dec_s", "--seq-len", str(o["seq_len"]),
            "--batch", str(o["batch"]), "--steps", str(o["steps"] + 1),
            "--ckpt-every", str(o["steps"]), "--ckpt-dir", str(root / "tp"),
            "--device", dev.type, "--data", str(D), "--model", str(M)]
    lines = dp.launch(D * M, "repro_torch.launch.train:run", args,
                      device=dev.type, timeout_s=600, model=M)
    ranks = {m["step"]: m for m in (json.loads(ln.split(" ", 3)[3])
                                    for ln in lines
                                    if ln.startswith("[train] step "))}
    held = json.loads(next(ln for ln in lines if ln.startswith(
        "[train] resident ")).split(" ", 2)[2])
    t_ranks = time.perf_counter() - t0
    ns = train.parser().parse_args(args)
    cfg, ocfg, params, opt, data = train.build(ns, dev)
    mesh = make_mesh_for([str(dev)] * (D * M), data=D, model=M)
    want = dryrun.state_bytes_per_dev(cfg, mesh, ocfg)
    got = list(zip(held["param_bytes"], held["moment_bytes"]))
    if got != [want] * (D * M):
        raise AssertionError(f"train.tp: resident bytes {got} != the dry "
                             f"run's {want} on every rank")
    step = build_train_step(cfg, ocfg)

    def batch(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.host_batch(s).items()}
    gaps = []
    for s in range(o["steps"]):
        params, opt, m = step(params, opt, batch(s))
        gaps.append(abs(float(m["loss"]) - ranks[s]["loss"]))
    (params, opt), at = elastic_restore(root / "tp", (params, opt),
                                        dp.Group.single(dev), step=o["steps"])
    _, _, m = step(params, opt, batch(o["steps"]))
    gaps.append(abs(float(m["loss"]) - ranks[o["steps"]]["loss"]))
    if not max(gaps) < 1e-3:
        raise AssertionError(f"train.tp: loss gaps {gaps} (bound 1e-3)")
    whole = sum(t.numel() * t.element_size()
                for t in tree_lib.leaves((params, opt)))

    def per_step(key):
        return ",".join(f"{ranks[s][key]:.1f}" for s in sorted(ranks))
    log("train.tp", t0, card=f"'{card}'", data=D, model=M,
        backend=dp.backend_for(dev.type, D * M), seq=o["seq_len"],
        global_batch=o["batch"], steps=len(ranks), resumed_at=at,
        ranks_s=f"{t_ranks:.1f}",
        loss_gaps=",".join(f"{g:.2e}" for g in gaps),
        resident_param_mb=f"{want[0] / 1e6:.2f}",
        resident_moment_mb=f"{want[1] / 1e6:.2f}",
        dryrun_per_dev_mb=f"{sum(want) / 1e6:.2f}",
        one_rank_mb=f"{whole / 1e6:.2f}", step_ms=per_step("step_ms"),
        data_mb=f"{ranks[0]['data_mb']:.1f}", data_ms=per_step("data_ms"),
        model_mb=f"{ranks[0]['model_mb']:.1f}",
        model_ms=per_step("model_ms"))


def train_flash_attn(torch, dev, root, card):
    """The FA2 autograd Function at the training shapes (bf16) against
    autograd through the plain masked softmax in float32 (out, dq, dk, dv
    within 2^-8 of each one's range, max - min: rounding a bf16 output
    alone costs up to 2^-8 of its largest magnitude), its forward and
    backward timed beside
    SDPA's (a yardstick: nothing on the path calls SDPA)."""
    import torch.nn.functional as F
    from repro_torch.models import attention as attn

    timer = Timer(torch, iters=10, warmup=2)
    g = torch.Generator(device=dev).manual_seed(11)
    for name, B, T, S, H, KV, causal in FLASH_SHAPES:
        t0 = time.perf_counter()
        D = 64

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).bfloat16()
        q, k, v, do = rnd(B, T, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D), \
            rnd(B, T, H, D)
        qpos = torch.arange(T, device=dev)[None].expand(B, T)
        kpos = torch.arange(S, device=dev)[None].expand(B, S)
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def fwd():
            return attn.flash_attention(*ins, qpos, kpos, causal=causal)
        out = fwd()
        grads = torch.autograd.grad(out, ins, do, retain_graph=True)
        ref_ins = [x.float().requires_grad_(True) for x in (q, k, v)]
        s = torch.einsum("bthd,bshd->bhts", ref_ins[0], ref_ins[1]) \
            * D ** -0.5
        msk = attn._mask(qpos, kpos, causal, 0)[:, None]
        w = torch.softmax(torch.where(msk, s, attn.NEG_INF), -1)
        ref = torch.einsum("bhts,bshd->bthd", w, ref_ins[2])
        ref_grads = torch.autograd.grad(ref, ref_ins, do.float())
        errs = []           # of each output's range, max - min
        for got, want in zip((out,) + grads, (ref,) + ref_grads):
            errs.append((got.float() - want).abs().max().item()
                        / (want.max() - want.min()).item())
        del s, w, ref, ref_grads, ref_ins
        if not max(errs) <= 2 ** -8:
            raise AssertionError(f"train.flash_attn.{name}: errors {errs}")
        fwd_ms = timer(fwd)
        bwd_ms = timer(lambda: torch.autograd.grad(out, ins, do,
                                                   retain_graph=True))
        sq, sk, sv = (x.detach().transpose(1, 2).contiguous()
                      .requires_grad_(True) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(sq, sk, sv,
                                                  is_causal=causal)
        sout = sdpa()
        sdo = do.transpose(1, 2).contiguous()
        sdpa_fwd = timer(sdpa)
        sdpa_bwd = timer(lambda: torch.autograd.grad(
            sout, (sq, sk, sv), sdo, retain_graph=True))
        log(f"train.flash_attn.{name}", t0, card=f"'{card}'", B=B, T=T, S=S,
            H=H, KV=KV, causal=causal,
            err_out_dq_dk_dv=",".join(f"{e:.2e}" for e in errs),
            fwd_ms=f"{fwd_ms:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            sdpa_fwd_ms=f"{sdpa_fwd:.4f}", sdpa_bwd_ms=f"{sdpa_bwd:.4f}")
        del out, grads, sout, ins
        torch.cuda.empty_cache()


def train_phases(torch, dev):
    """The training phases named in ``TRAIN_PHASES``, in that order."""
    import gc

    phases = {"dec_s": train_dec_s, "encdec_s": train_encdec_s,
              "dp": train_dp, "tp": train_tp, "flash_attn": train_flash_attn}
    card = nvidia_smi()
    root = train_root()
    for name in TRAIN_PHASES:
        phases[name](torch, dev, root, card)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the dry run's step builders, the search tools and the quickstart on the
# card, over what the Dec-S phases built
# ---------------------------------------------------------------------------

STEPS_SERVE = dict(steps=16, check_step=8)


def to_device(torch, tree, dev):
    """A tree of tensors (dicts, NamedTuples) on ``dev``."""
    from repro_torch import tree as tree_lib
    return tree_lib.map(lambda t: t.to(dev), tree)


def steps_serve(torch, dev, kept, card):
    """``build_prefill_step`` + ``build_serve_step`` for Dec-S at
    decode_32k on a one-position mesh, at full width with the smoke's
    weights, its 4 194 304-key index and payload: 32 rows (the 8 x 4
    prompts, 448 tokens: 447 prefilled, the last fed to the first step)
    with a cache of 512, then 16 greedy steps. One step's state is
    copied to the CPU and run there through the plain versions."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.chamvs import stack_shards
    from repro_torch.core.ivfpq import id_swaps
    from repro_torch.kernels import _build
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    sizes, ds = kept["sizes"], kept["ds"]
    spec = get_arch("dec_s")
    cfg = spec.model
    mesh = Mesh(("data", "model"), (1, 1), (str(dev),))
    db = specs.ServeDBSpec(n_vectors=ds.num_vectors, nlist=sizes["nlist"],
                           nprobe=sizes["nprobe"],
                           residual=ds.index_cfg.residual)
    prefill, _ = steps.build_prefill_step(spec, "prefill_32k", mesh)
    serve, _, (ccfg, _) = steps.build_serve_step(
        spec, "decode_32k", mesh, db=db)
    if ccfg.ivfpq.m != ds.index_cfg.m:
        raise AssertionError(f"for_model m {ccfg.ivfpq.m} != index m "
                             f"{ds.index_cfg.m}")
    params, dbp, payload = kept["params"], ds.params, ds.payload_tokens
    stacked = stack_shards(ds.shards)
    R, B, T0 = sizes["requests"], sizes["rows"], sizes["prompt_len"]
    W, n_steps = R * B, STEPS_SERVE["steps"]
    prompt = torch.from_numpy(kept["corpus"][:W, :T0]).to(dev)
    caches = tf.init_cache(cfg, W, sizes["max_seq"], device=dev)
    recorded = []
    search = serve.search

    def recording_search(*a):
        out = search(*a)
        recorded.append((a[2], out))
        return out

    serve.search = recording_search
    torch.cuda.synchronize()
    _build.reset_launches()
    pos = torch.arange(T0 - 1, device=dev)[None].expand(W, T0 - 1)
    _, caches = prefill(params, caches, {"tokens": prompt[:, :T0 - 1],
                                         "positions": pos})
    tok, ms, gen, kept_logp = prompt[:, T0 - 1:], [], [], []
    for s in range(n_steps):
        batch = {"token": tok, "position": torch.full(
            (W,), T0 - 1 + s, dtype=torch.int32, device=dev)}
        if s == STEPS_SERVE["check_step"]:
            state = (to_device(torch, caches, "cpu"),
                     {k: v.cpu() for k, v in batch.items()})
            recorded.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logp, caches = serve(params, caches, batch, dbp, stacked, payload)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        if s == STEPS_SERVE["check_step"]:
            card_logp = logp.float().cpu()
            card_query, (d_card, i_card) = recorded[0]
        if s < STEPS_MESH["steps"]:
            kept_logp.append(logp.float().cpu())
        tok = logp.argmax(-1, keepdim=True).int()
        gen.append(tok)
    launches = {n: k.launches for n, k in _build.kernels().items()}
    serve.search = search
    gen = torch.cat(gen, 1).cpu().numpy()
    want = {"decode_attn_launch": cfg.n_layers * n_steps,
            "ivf_scan_launch": n_steps, "chamvs_scan_launch": n_steps}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"steps.serve launches {launches} != {want}")
    if not np.isfinite(card_logp.numpy()).all():
        raise AssertionError("steps.serve: non-finite log-probs")
    truth = kept["corpus"][:W, T0:T0 + n_steps]
    # the same step on the CPU, from the copied state, through the plain
    # versions. Its search takes the card's query: the two devices' bf16
    # hidden states part in their last bits, which can move a PQ
    # neighbour across the K-th boundary and with it the mix
    t1 = time.perf_counter()
    cpu_params = to_device(torch, params, "cpu")
    ds_cpu = ds.to("cpu")
    to_host_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu_caches, cpu_batch = state
    cpu_search = {}

    def card_query_search(db_params, db_shard, query):
        cpu_search["query"] = query
        cpu_search["out"] = search(db_params, db_shard, card_query.cpu())
        return cpu_search["out"]

    serve.search = card_query_search
    cpu_logp, _ = serve(cpu_params, cpu_caches, cpu_batch,
                        ds_cpu.params, stack_shards(ds_cpu.shards),
                        ds_cpu.payload_tokens)
    serve.search = search
    cpu_s = time.perf_counter() - t1
    d_cpu, i_cpu = cpu_search["out"]
    q_err = float((cpu_search["query"] - card_query.cpu()).abs().max()
                  / card_query.abs().max().cpu())
    swaps = id_swaps(d_card, i_card, d_cpu, i_cpu)
    scale = float(cpu_logp.max() - cpu_logp.min())
    err = float((card_logp - cpu_logp).abs().max())
    if err > 2 ** -5 * scale:
        raise AssertionError(f"steps.serve: log-probs differ by {err} > "
                             f"2^-5 x {scale}")
    tie = near_tie_check(torch, "steps.serve tokens",
                         card_logp.argmax(-1)[:, None].numpy(),
                         card_logp[:, None], cpu_logp.argmax(-1)[:, None]
                         .numpy(), cpu_logp[:, None], B)
    log("steps.serve", t0, card=card, rows=W, prompt_len=T0,
        cache=sizes["max_seq"], steps=n_steps, nprobe=ccfg.nprobe,
        k=ccfg.k, kprime=ccfg.k_prime(stacked.codes.shape[0]),
        step_ms_median=f"{median(ms):.2f}",
        step_ms_range=f"{min(ms):.2f}-{max(ms):.2f}",
        launches={k: launches[k] for k in want},
        continuation_accuracy=f"{(gen == truth).mean():.4f}",
        weights_index_to_host_s=f"{to_host_s:.2f}",
        cpu_step_s=f"{cpu_s:.1f}", query_rel_err=f"{q_err:.3g}",
        logp_max_err=f"{err:.3g}",
        logp_range=f"{scale:.3g}", tokens_differ=tie["rows_differ"],
        search_ids_identical=swaps == 0, near_tie_id_swaps=swaps)
    n = STEPS_MESH["steps"]
    return dict(gen=gen[:, :n], logp=torch.stack(kept_logp, 1))


# ---------------------------------------------------------------------------
# the sharded prefill and serve steps: Dec-S on a data x model mesh of
# ranks sharing the card
# ---------------------------------------------------------------------------

#: 2 x 2 ranks; greedy serve steps after the prefill (steps.serve's first
#: ``steps`` are the reference)
STEPS_MESH = dict(data=2, model=2, steps=6)


def mesh_rank(group, argv):
    """One rank of ``steps.mesh`` (``launch.dp``'s entry
    ``chip_smoke:mesh_rank``, argv ``[dir]``): Dec-S's sharded prefill and
    serve steps (``launch.steps`` with the rank's group) on the shards
    ``put_named`` gives it of the smoke's weights, index and payload
    (``dir/case.pt``), then ``steps`` greedy steps, each rank taking its
    rows' tokens by ``argmax_over_model``. Writes ``rank<r>.json``: the
    launches, the resident bytes beside the dry run's per-device count of
    the same arguments, step ms and each axis's collective MB and ms a
    step; rank 0 also ``out.pt``, every step's whole log-probs and
    tokens."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import parallel
    from repro_torch.models.sharding import (P, _map_specs, gather_named,
                                             put_named, sanitize,
                                             shard_shape)

    root = pathlib.Path(argv[0])
    case = torch.load(root / "case.pt", mmap=True, weights_only=False)
    B, S, T0, n = case["rows"], case["max_seq"], case["prompt_len"], \
        case["steps"]
    SHAPES["mesh_prefill"] = dict(kind="prefill", seq_len=S, global_batch=B)
    SHAPES["mesh_decode"] = dict(kind="decode", seq_len=S, global_batch=B)
    spec = get_arch(case["arch"])
    if case.get("reduced"):             # a rehearsal at the reduced widths
        spec = dataclasses.replace(spec, model=spec.reduced)
    cfg, mesh, dev = spec.model, group.mesh, group.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prefill, (p_specs, c_specs, b_specs) = steps_lib.build_prefill_step(
        spec, "mesh_prefill", mesh, group=group)
    serve, shardings, (_, structs) = steps_lib.build_serve_step(
        spec, "mesh_decode", mesh, db=specs.ServeDBSpec(**case["db"]),
        group=group)
    held = {k: sanitize(shardings[k], structs[k], mesh)
            for k in ("batch", "db_params", "db_shard", "payload")}

    def put(tree, spec_tree):
        return put_named(tree, spec_tree, mesh, group)

    def meta(tree):
        return tree_lib.map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), tree)

    c_struct = specs.cache_struct(spec, "mesh_decode")
    caches = _map_specs(lambda sp, t: torch.zeros(
        shard_shape(t.shape, sp, mesh), dtype=t.dtype, device=dev),
        c_specs, c_struct)
    params = put(case["params"], p_specs)
    args = dict(db_params=put(case["db_params"], held["db_params"]),
                db_shard=put(case["db_shard"], held["db_shard"]),
                payload=put(case["payload"], held["payload"]))
    pos0 = torch.full((B,), T0 - 1, dtype=torch.int32)
    batch = put({"token": case["prompt"][:, T0 - 1:].contiguous(),
                 "position": pos0}, held["batch"])
    resident = sum(t.numel() * t.element_size() for t in tree_lib.leaves(
        (params, caches, batch, args)))
    count = (dryrun._bytes_per_dev(steps_lib.abstract_params(cfg), p_specs,
                                   mesh)
             + dryrun._bytes_per_dev(c_struct, c_specs, mesh)
             + dryrun._bytes_per_dev(structs["batch"], shardings["batch"],
                                     mesh)
             + sum(dryrun._bytes_per_dev(meta(case[k]), shardings[k], mesh)
                   for k in args))
    out_spec = sanitize(P(("data",), "model"),
                        specs.S((B, cfg.vocab_size), torch.float32), mesh)
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    prompt = case["prompt"][:, :T0 - 1].contiguous()
    positions = torch.arange(T0 - 1, dtype=torch.int32)[None].expand(
        B, T0 - 1).contiguous()
    _, caches = prefill(params, caches, put(
        {"tokens": prompt, "positions": positions}, b_specs))
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre_stats = prefill.stats()
    step_ms, stats, logps = [], [], []
    tok = batch["token"]
    for s in range(n):
        b = {"token": tok, "position": batch["position"] + s}
        sync()
        t0 = time.perf_counter()
        logp, caches = serve(params, caches, b, **args)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        stats.append(serve.stats())
        tok = parallel.argmax_over_model(logp, group.axis("model"))
        whole = gather_named(logp, out_spec, mesh, group)
        if group.rank == 0:
            logps.append(whole.float().cpu())
    launches = {k: kern.launches for k, kern in _build.kernels().items()}
    (root / f"rank{group.rank}.json").write_text(json.dumps(dict(
        launches=launches, resident=resident, dryrun_count=count,
        prefill_ms=prefill_ms, prefill_stats=pre_stats, step_ms=step_ms,
        stats=stats, coords=group.coords)))
    if group.rank == 0:
        logp = torch.stack(logps, 1)
        torch.save(dict(logp=logp, gen=logp.argmax(-1).int()),
                   root / "out.pt")


def kernel_decode_attn_partial(torch, dev, timer, report, W, H, KV, D, S,
                               R, positions):
    """The partial mode at the mesh step's shapes: a rank's ``W`` rows
    over its ``S`` slots of a cache split in ``R`` ranges, one launch
    per range with its slot offset, merged (``merge_partials``) and held
    against the plain version (2^-5 of the output range) and a float32
    oracle over the whole cache (2^-8); timed on range 0 (every slot
    valid) beside its plain version and the library's one call for the
    same function (memory-efficient SDPA with its log-sum-exp, the
    validity as a -inf bias: the normalised form of the partial), the
    last range logged."""
    from repro_torch.kernels.decode_attn import ops as da
    from repro_torch.kernels.decode_attn.ref import (
        merge_partials, ref_decode_attention_partial)

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn((W, S * R, KV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((W, S * R, KV, D), generator=g, device=dev).bfloat16()
    q = torch.randn((W, 1, H, D), generator=g, device=dev).bfloat16()
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    ranges = [(k[:, r * S:(r + 1) * S].contiguous(),
               v[:, r * S:(r + 1) * S].contiguous()) for r in range(R)]
    parts = [da.decode_attention_partial(q, kr, vr, pos, slot_offset=r * S)
             for r, (kr, vr) in enumerate(ranges)]
    plain = [ref_decode_attention_partial(q, kr, vr, pos, r * S)
             for r, (kr, vr) in enumerate(ranges)]
    out = merge_partials(*(torch.stack(t) for t in zip(*parts)))
    want = merge_partials(*(torch.stack(t) for t in zip(*plain)))
    exact = da.ref_decode_attention(q.float(), k.float(), v.float(), pos
                                    )[:, 0]
    torch.cuda.synchronize()
    scale = exact.abs().max().item()
    err = (out - want).abs().max().item()
    err32 = (out - exact).abs().max().item()
    if not (err <= 2 ** -5 * scale + 1e-3 and err32 <= 2 ** -8 * scale +
            1e-5):
        raise AssertionError(f"decode_attn_partial: err {err}, vs f32 "
                             f"{err32} (range {scale})")
    times = []
    for r in (0, R - 1):
        kr, vr = ranges[r]
        n_valid = int((pos[:, None] - r * S >= torch.arange(
            S, device=dev)[None]).sum())
        nbytes = 2 * n_valid * KV * D * 2 + q.numel() * 2 + W * 4 + \
            W * H * (D + 2) * 4
        times.append(dict(
            ms=timer(lambda: da.decode_attention_partial(
                q, kr, vr, pos, slot_offset=r * S)),
            plain_ms=timer(lambda: ref_decode_attention_partial(
                q, kr, vr, pos, r * S)),
            bound=bound(nbytes, 4 * n_valid * H * D), nbytes=nbytes,
            valid=n_valid))
    # the library's call on range 0: [W, H, 1, D] against [W, KV, S, D]
    # (KV = H here, no head repeat), slots past a row's position masked
    kr, vr = (x.transpose(1, 2) for x in ranges[0])
    if kr.shape[1] != H:
        raise AssertionError("decode_attn_partial: the library call "
                             "needs H = KV")
    qt = q.transpose(1, 2)
    bias = torch.zeros((W, H, 1, S), dtype=q.dtype, device=dev)
    bias.masked_fill_((torch.arange(S, device=dev)[None] > pos[:, None])
                      [:, None, None], float("-inf"))

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kr, vr, bias, True, scale=D ** -0.5)
    lib_out = library()[0][:, :, 0].float()
    acc0, _, l0 = parts[0]
    lib_err = (lib_out - acc0 / l0[..., None]).abs().max().item()
    library_ms = timer(library)
    t = times[0]
    report["decode_attn_partial"] = dict(
        name="decode_attn_partial", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/kernel.py:109",
        max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound"][0], bound_by=t["bound"][1],
        library_ms=library_ms)
    log("kernel.decode_attn_partial", t0,
        shape=f"W={W},H={H},KV={KV},D={D},S_local={S},ranges={R}",
        max_abs_err=f"{err:.3e}", err_vs_f32=f"{err32:.3e}",
        ms=f"{t['ms']:.4f}", plain_ms=f"{t['plain_ms']:.4f}",
        library_ms=f"{library_ms:.4f}",
        library_err_vs_range0=f"{lib_err:.3e}",
        bound_ms=f"{t['bound'][0]:.4f}",
        bytes=t["nbytes"], valid_slots=t["valid"],
        last_range_ms=f"{times[1]['ms']:.4f}",
        last_range_plain_ms=f"{times[1]['plain_ms']:.4f}",
        last_range_bound_ms=f"{times[1]['bound'][0]:.4f}",
        last_range_valid_slots=times[1]["valid"])


def steps_mesh(torch, dev, kept, card, ref, report):
    """``build_prefill_step`` + ``build_serve_step`` with a rank group:
    Dec-S at full width on a 2 x 2 mesh of 4 ranks sharing the card (gloo
    through host memory), the smoke's weights, its 4 194 304-key index
    (one shard per data coordinate) and the payload split over data x
    model, ``steps.serve``'s 32 rows (447 prefilled, a cache of 512),
    then ``steps`` greedy steps. Tokens held to ``steps.serve``'s first
    steps by the near-tie rule (the ranks' GEMM shapes differ from one
    process's); every rank's resident bytes equal to the dry run's count
    of the same arguments; each rank launches decode attention's partial
    mode once a layer a step, the IVF probe and the fused scan once a
    step, the whole-wave decode attention never. The partial mode is
    first held against its plain version and timed at the ranks'
    shapes."""
    import shutil

    from repro_torch.core.chamvs import stack_shards
    from repro_torch.launch import dp

    o = STEPS_MESH
    D, M, n = o["data"], o["model"], o["steps"]
    sizes, ds, cfg = kept["sizes"], kept["ds"], kept["arch"].model
    W, S, T0 = sizes["requests"] * sizes["rows"], sizes["max_seq"], \
        sizes["prompt_len"]
    timer = Timer(torch)
    kernel_decode_attn_partial(
        torch, dev, timer, report, W // D, cfg.n_heads, cfg.n_kv_heads,
        cfg.d_head, S // M, M, [T0 - 1 + s for s in range(W // D)])
    del timer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    root = ROOT / "build" / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.save(dict(
        params=to_device(torch, kept["params"], "cpu"),
        db=dict(n_vectors=ds.num_vectors, nlist=sizes["nlist"],
                nprobe=sizes["nprobe"], residual=ds.index_cfg.residual),
        db_params=to_device(torch, ds.params, "cpu"),
        db_shard=to_device(torch, stack_shards(ds.shards), "cpu"),
        payload=ds.payload_tokens.cpu(),
        prompt=torch.from_numpy(kept["corpus"][:W, :T0].copy()),
        arch="dec_s", rows=W, max_seq=S, prompt_len=T0, steps=n),
        root / "case.pt")
    t_save = time.perf_counter() - t0
    dp.launch(D * M, "chip_smoke:mesh_rank", [str(root)], device=dev.type,
              timeout_s=300, model=M)
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(D * M)]
    out = torch.load(root / "out.pt", weights_only=False)
    want = dict.fromkeys(ranks[0]["launches"], 0)
    want.update({"decode_attn_partial_launch": cfg.n_layers * n,
                 "ivf_scan_launch": n, "chamvs_scan_launch": n})
    for r, rk in enumerate(ranks):
        if rk["launches"] != want:
            raise AssertionError(f"steps.mesh rank {r}: launches "
                                 f"{rk['launches']} != {want}")
        if rk["resident"] != rk["dryrun_count"]:
            raise AssertionError(f"steps.mesh rank {r}: resident bytes "
                                 f"{rk['resident']} != the dry run's "
                                 f"{rk['dryrun_count']}")
    if not bool(torch.isfinite(out["logp"]).all()):
        raise AssertionError("steps.mesh: non-finite log-probs")
    tie = near_tie_check(torch, "steps.mesh tokens", out["gen"].numpy(),
                         out["logp"], ref["gen"], ref["logp"],
                         sizes["rows"])
    truth = kept["corpus"][:W, T0:T0 + n]
    report["decode_attn_partial"].update(
        launches=ranks[0]["launches"]["decode_attn_partial_launch"],
        launches_in=f"steps.mesh (each of {D * M} ranks)")
    for name, sym in (("ivf_scan", "ivf_scan_launch"),
                      ("fused_scan", "chamvs_scan_launch")):
        report[name].update(
            launches_steps_mesh=[rk["launches"][sym] for rk in ranks],
            launches_steps_mesh_in="steps.mesh (each rank)")

    def per_step(key):
        return ",".join(f"{st[key]:.1f}" for st in ranks[0]["stats"])
    log("steps.mesh", t0, card=card, data=D, model=M,
        backend=dp.backend_for(dev.type, D * M), rows=W, prompt_len=T0,
        cache=S, steps=n, save_s=f"{t_save:.1f}",
        prefill_ms=f"{ranks[0]['prefill_ms']:.1f}",
        step_ms=",".join(f"{x:.1f}" for x in ranks[0]["step_ms"]),
        step_ms_median=f"{median(ranks[0]['step_ms']):.1f}",
        data_mb=f"{ranks[0]['stats'][-1]['data_mb']:.2f}",
        data_ms=per_step("data_ms"),
        model_mb=f"{ranks[0]['stats'][-1]['model_mb']:.2f}",
        model_ms=per_step("model_ms"),
        mesh_mb=f"{ranks[0]['stats'][-1]['mesh_mb']:.3f}",
        mesh_ms=per_step("mesh_ms"),
        prefill_data_mb=f"{ranks[0]['prefill_stats']['data_mb']:.1f}",
        prefill_model_mb=f"{ranks[0]['prefill_stats']['model_mb']:.1f}",
        resident_mb=",".join(f"{rk['resident'] / 1e6:.2f}" for rk in ranks),
        dryrun_per_dev_mb=f"{ranks[0]['dryrun_count'] / 1e6:.2f}",
        launches={k: v for k, v in want.items() if v},
        continuation_accuracy=f"{(out['gen'].numpy() == truth).mean():.4f}",
        tokens_differ=tie["rows_differ"], near_tie_noise=f"{tie['noise']:.3g}")


def search_tools(torch, dev, arch, sizes, keys, queries, ds, card):
    """``exact_search`` over every key of the index on the card (ids
    equal to the CPU's), ``recall_at_k`` of the fused search against it,
    and ``search_single`` fused and staged on the 32 kernel queries (ids
    identical to each other and to a service built as the engine builds
    it); one fused scan a fused call, one ``adc_scan`` a shard a staged
    one. ``keys``, ``queries`` and ``ds`` lie on the card; the keys'
    copy to the host for the CPU's exact search is timed and freed."""
    from repro_torch.core import chamvs
    from repro_torch.core.ivfpq import exact_search, id_swaps, recall_at_k
    from repro_torch.kernels import _build
    from repro_torch.retrieval import RetrievalService

    t0 = time.perf_counter()
    k = arch.rag.k
    q = queries
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d_e, i_e = exact_search(keys, q, k)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    keys_cpu, q_cpu = keys.cpu(), q.cpu()
    to_host_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    d_ec, i_ec = exact_search(keys_cpu, q_cpu, k)
    cpu_s = time.perf_counter() - t1
    del keys_cpu
    swaps = id_swaps(d_e, i_e, d_ec, i_ec,
                     terms=2.0 * (q_cpu * q_cpu).sum(1))
    out, launches = {}, {}
    for fused in (True, False):
        cfg = ds.search_config(nprobe=sizes["nprobe"], k=k, fused=fused)
        chamvs.search_single(ds.params, ds.shards, q, cfg)   # the memo
        torch.cuda.synchronize()
        _build.reset_launches()
        out[fused] = chamvs.search_single(ds.params, ds.shards, q, cfg)
        torch.cuda.synchronize()
        launches[fused] = {n: kern.launches
                           for n, kern in _build.kernels().items()
                           if kern.launches}
    svc = RetrievalService.local(ds.params, ds.shards,
                                 ds.search_config(nprobe=sizes["nprobe"],
                                                  k=k))
    d_s, i_s = svc.search(q)
    S = ds.num_shards
    if launches[True] != {"ivf_scan_launch": 1, "chamvs_scan_launch": 1} \
            or launches[False] != {"ivf_scan_launch": 1,
                                   "adc_scan_launch": S}:
        raise AssertionError(f"search_single launches {launches}")
    for name, (d, i) in (("staged", out[False]), ("service", (d_s, i_s))):
        if not bool(torch.equal(i, out[True][1])):
            raise AssertionError(f"search_single fused ids != {name}")
    chamvs._SERVICE_MEMO.clear()
    log("search.tools", t0, card=card, queries=tuple(q.shape),
        keys=tuple(keys.shape), k=k,
        exact_card_s=f"{card_s:.2f}", keys_to_host_s=f"{to_host_s:.2f}",
        exact_cpu_s=f"{cpu_s:.1f}",
        exact_ids_identical=swaps == 0, exact_near_tie_swaps=swaps,
        recall_at_k=f"{recall_at_k(out[True][1], i_e):.4f}",
        r10_at_k=f"{recall_at_k(out[True][1], i_e[:, :10]):.4f}",
        fused_launches=launches[True], staged_launches=launches[False],
        fused_eq_staged_eq_service=True)


def quickstart_phase(torch, card):
    """The quickstart twin's ``main()`` on the card: its index (16 384 x
    64, 4 shards), R10@32, and the same search on the CPU: distances
    within 1e-5, ids identical but at near ties."""
    from repro_torch.examples import quickstart

    t0 = time.perf_counter()
    out = quickstart.main([])            # raises if card != plain
    if out["device"] != "cuda":
        raise AssertionError(f"quickstart ran on {out['device']}")
    log("quickstart", t0, card=card, r10_at_32=f"{out['recall']:.3f}",
        ids_identical=out["swaps"] == 0, near_tie_id_swaps=out["swaps"],
        dists_within_1e5=True)


def main() -> int:
    import gc

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

    report, kept = run_phases(torch, dev, dict(FULL))
    gc.collect()
    torch.cuda.empty_cache()
    paper_phases(torch, dev, dict(FULL), report)
    gc.collect()
    torch.cuda.empty_cache()
    assigned_phases(torch, dev, dict(FULL), report)
    gc.collect()
    torch.cuda.empty_cache()
    nondense_phases(torch, dev, dict(FULL), report)
    gc.collect()
    torch.cuda.empty_cache()
    train_phases(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    card = nvidia_smi()
    ref = steps_serve(torch, dev, kept, card)
    steps_mesh(torch, dev, kept, card, ref, report)
    del kept, ref
    gc.collect()
    torch.cuda.empty_cache()
    quickstart_phase(torch, card)
    kernels = [report[k] for k in ("decode_attn", "decode_attn_partial",
                                   "ivf_scan", "fused_scan", "adc_scan",
                                   "shared_scan", "hierarchical_topk")]
    log("total", t_all,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
