"""Serving launcher: ``python -m repro_torch.launch.serve [...]`` (twin of
``repro.launch.serve``).

Builds a small RALM deployment end to end through ``repro_torch.serve``:
seeded random weights, a ``DatastoreBuilder`` over a synthetic corpus,
an ``EngineConfig``, and either a few request batches driven in-process
(the default) or the HTTP gateway (``--gateway``).

It runs on the GPU and raises when CUDA is absent, unless given
``--device cpu`` (the plain PyTorch versions of the kernels). There are
no kernel-backend flags: the device decides. ``--staged-scan`` serves
the staged per-shard scan (``search_config(fused=False)``).
``--disaggregate`` serves from an LM pool (this process) and a
retrieval pool of two memory-node processes on the same device kind,
one DB shard each (the datastore is built with as many shards), and
prints the pools' step times and the fabric's traffic. ``--arch``
serves the paper's decoders (``dec_s``, ``dec_l``) and the assigned
decoder backbones (dense: ``qwen2_0_5b``, ``phi3_mini_3_8b``,
``gemma3_4b``, ``llama3_405b``, ``qwen2_vl_72b``; MoE:
``phi3_5_moe_42b``, ``dbrx_132b``; hybrid: ``hymba_1_5b``; RWKV-6:
``rwkv6_3b``; at published width where they fit the card,
``--reduced`` on either device) as kNN-LMs. The RETRO encoder-decoders
(``encdec_s``, ``encdec_l``, ``seamless_m4t_medium``) are refused: the
launcher's datastore holds next tokens only, no chunk table, so their
first retrieval would raise (the reference's launcher raises there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tf
from repro_torch.serve import (DatastoreBuilder, EngineConfig, RalmEngine,
                               RalmRequest)


RET_DEVICES = 2      # memory nodes of --disaggregate (the reference's)


def build_datastore(params, cfg, rng, device, n_docs=64, doc_len=32,
                    num_shards=2):
    """kNN-LM datastore over a synthetic corpus (the recipe lives in
    ``DatastoreBuilder``)."""
    corpus = rng.integers(0, cfg.vocab_size, size=(n_docs, doc_len),
                          dtype=np.int32)
    return DatastoreBuilder(dim=cfg.d_model, nlist=8, list_cap=None,
                            num_shards=num_shards,
                            device=str(device)).from_corpus(params, cfg,
                                                            corpus)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dec_s")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                         "CUDA). 'cpu' runs the kernels' plain versions")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced test shape instead of the published "
                         "widths")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--requests", type=int, default=2,
                    help="concurrent request batches (pipelined)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="serve from an LM pool (this process) and a "
                         "retrieval pool of 2 memory-node processes")
    ap.add_argument("--async-retrieval", action="store_true",
                    help="route searches through a RetrievalService "
                         "(wave coalescing + result cache)")
    ap.add_argument("--retrieval-cache", type=int, default=0,
                    help="RetrievalService LRU cache entries (0 = off)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="speculative retrieval depth: due steps decode "
                         "ahead on stale neighbours while the real search "
                         "runs async; verified (and rolled back on "
                         "mismatch) k waves later. Requires "
                         "--async-retrieval. 0 = off")
    ap.add_argument("--no-speculate-verify", action="store_true",
                    help="skip verify-and-rollback: trust stale "
                         "neighbours outright")
    ap.add_argument("--retrieval-deadline-ms", type=float, default=0.0,
                    help="per-dispatch retrieval latency budget in ms (0 = "
                         "wait indefinitely); arms the fault-tolerant "
                         "dispatch layer; requires --async-retrieval")
    ap.add_argument("--hedge-quantile", type=float, default=0.95,
                    help="latency quantile after which a hung retrieval "
                         "dispatch is hedged to another replica")
    ap.add_argument("--shard-replicas", type=int, default=1,
                    help="dispatch-target replicas per retrieval fault "
                         "domain (>1 arms replica failover; requires "
                         "--async-retrieval)")
    ap.add_argument("--chaos", default=None, metavar="PLAN.json",
                    help="arm a FaultPlan (JSON) at the retrieval scan "
                         "boundary")
    ap.add_argument("--no-retrieval-measure", action="store_true",
                    help="drop the per-flush stage-timing device syncs")
    ap.add_argument("--per-sequence", action="store_true",
                    help="per-sequence decode (one LM step per request) "
                         "instead of wave decode over the KV-cache pool")
    ap.add_argument("--kv-slots", type=int, default=None,
                    help="fix the KV pool capacity in prompt rows; "
                         "default grows on demand")
    ap.add_argument("--staged-scan", action="store_true",
                    help="per-shard staged scan (one adc_scan per shard) "
                         "instead of the fused single-launch scan")
    ap.add_argument("--attn-seq-block", type=int, default=16,
                    help="KV-pool seq-axis alignment quantum: per-wave "
                         "attention reads crop to this multiple")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable the tracer and write the Chrome "
                         "trace-event JSON here on exit")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus text exposition of the "
                         "run's metrics after the demo batches (with "
                         "--gateway the same data is live at GET /metricsz)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve over HTTP instead of running the demo "
                         "batches: /v1/completions with SSE streaming, "
                         "per-tenant admission, load-shedding degradation")
    ap.add_argument("--port", type=int, default=8000,
                    help="gateway listen port (with --gateway)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="gateway bind address (with --gateway)")
    args = ap.parse_args(argv)
    spec = get_arch(args.arch)
    if spec.model.arch == "encdec":
        ap.error(f"--arch {args.arch} is a RETRO encoder-decoder: this "
                 "launcher's datastore has no chunk table, so its first "
                 "retrieval would raise; serve it through RalmEngine with "
                 "DatastoreBuilder.build(..., chunk_table=...)")
    return args


def build_engine(args: argparse.Namespace) -> RalmEngine:
    """The deployment ``args`` describe, on its device."""
    dev = device_lib.resolve(args.device)
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.model
    rag = spec.rag
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    ret_devices = RET_DEVICES if args.disaggregate else 1
    ds = build_datastore(params, cfg, np.random.default_rng(0), dev,
                         num_shards=ret_devices if args.disaggregate else 2)
    ccfg = ds.search_config(nprobe=4, k=min(rag.k, 8),
                            fused=not args.staged_scan)
    econfig = EngineConfig(
        model=cfg, rag=rag, disaggregate=args.disaggregate, lm_devices=1,
        ret_devices=ret_devices, async_retrieval=args.async_retrieval,
        retrieval_cache=args.retrieval_cache,
        retrieval_measure=not args.no_retrieval_measure,
        speculate_k=args.speculate_k,
        speculate_verify=not args.no_speculate_verify,
        wave_decode=not args.per_sequence, kv_slots=args.kv_slots,
        attn_seq_block=args.attn_seq_block,
        retrieval_deadline_s=args.retrieval_deadline_ms / 1e3,
        hedge_quantile=args.hedge_quantile,
        shard_replicas=args.shard_replicas, chaos_plan=args.chaos,
        trace=args.trace is not None, trace_path=args.trace)
    return RalmEngine.from_config(econfig, params, ds, ccfg, device=dev)


def report(engine: RalmEngine, responses, dt: float) -> None:
    mode = "wave" if engine.wave else "per-sequence"
    for resp in responses:
        print(f"[serve] {mode} request {resp.request_id}: "
              f"{resp.tokens.shape} last tokens "
              f"{resp.tokens[:, -4:].tolist()}")
    ntok = sum(r.tokens.shape[0] * r.steps for r in responses)
    print(f"[serve] {mode}: {len(responses)} batches, {ntok} tokens in "
          f"{dt:.2f}s ({ntok / dt:.1f} tok/s), {engine.decode_dispatches} "
          f"LM dispatches on {engine.device}")
    if engine.pool is not None:
        ps = engine.pool.stats
        print(f"[serve] kv pool: {engine.pool.capacity} slots "
              f"(high water {ps.high_water}), {ps.waves} waves avg "
              f"{ps.mean_wave():.1f} rows, buckets {sorted(ps.buckets)}; "
              f"{ps.blocks_skipped}/{ps.blocks_total} seq blocks skipped "
              f"({ps.skip_fraction():.0%} of pool padding), "
              f"{ps.decode_compiles} wave shapes")
    if engine.times is not None:
        t = engine.times
        print(f"[serve] pools: decode {np.median(t.decode_s) * 1e3:.2f} ms "
              f"a step, search {np.median(t.search_s) * 1e3:.2f} ms a "
              f"step (medians of {len(t.decode_s)} / {len(t.search_s)}); "
              f"optimal LM:retrieval ratio {t.optimal_ratio():.2f}")
    router = getattr(engine.retriever, "router", None)
    if router is not None:
        for op, c in sorted(router.fabric.counters.items()):
            print(f"[serve] fabric {op}: {c.round_trips} round trips, "
                  f"{c.bytes_out / max(c.round_trips, 1):.0f} B out / "
                  f"{c.bytes_in / max(c.round_trips, 1):.0f} B in and "
                  f"{c.seconds / max(c.round_trips, 1) * 1e3:.3f} ms each, "
                  f"{router.fabric.size} memory nodes")
    service = getattr(engine.retriever, "service", None)
    if service is None:
        return
    st = service.stats
    line = (f"[serve] retrieval service: {st.batched_rows} rows in "
            f"{st.num_batches} waves / {st.scan_dispatches} scan dispatches "
            f"(coalescing {st.coalescing_factor():.1f}x, cache "
            f"{st.cache_hits} hit / {st.cache_misses} miss)")
    if service.config.measure:
        line += (f"; queue-wait {st.queue_wait.mean_s * 1e6:.0f}us "
                 f"scan {st.scan.mean_s * 1e6:.0f}us "
                 f"merge {st.merge.mean_s * 1e6:.0f}us")
    print(line)
    if service.replicas is not None:
        states = service.replicas.state_counts()
        print(f"[serve] fault tolerance: {st.ft_timeouts} timeouts, "
              f"{st.ft_hedges} hedges, {st.ft_retries} retries, "
              f"{st.ft_crashes} crashes -> {st.ft_ejections} ejections / "
              f"{st.ft_recoveries} recoveries; {st.ft_partial_flushes} "
              f"partial flushes ({st.ft_partial_rows} rows); replicas "
              + " ".join(f"{k}={v}" for k, v in states.items() if v))
    if st.spec_issued:
        print(f"[serve] speculation: {st.spec_issued} issued, "
              f"{st.spec_accepted}/{st.spec_verified} accepted "
              f"({st.spec_acceptance_rate():.0%}), {st.spec_rollbacks} "
              f"rollbacks ({st.spec_replayed_steps} steps replayed)")


def main(argv=None) -> None:
    args = parse_args(argv)
    with build_engine(args) as engine:
        serve(args, engine)


def serve(args: argparse.Namespace, engine: RalmEngine) -> None:
    if args.gateway:
        from repro_torch.serve import Gateway, GatewayConfig
        if engine.device.type == "cuda":
            # build the kernels now, not under the first request
            from repro_torch.kernels import _build
            _build.library()
        Gateway(engine, GatewayConfig(host=args.host,
                                      port=args.port)).serve_forever()
        if args.trace:
            print(f"[serve] trace written to {engine.write_trace()}")
        return

    cfg = engine.cfg
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             size=(args.batch, 8),
                                             dtype=np.int32))
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    for prompt in prompts:
        engine.submit(RalmRequest(prompt=prompt, steps=args.steps))
    responses = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    report(engine, responses, time.perf_counter() - t0)
    if args.trace:
        print(f"[serve] trace written to {engine.write_trace()} "
              f"({len(engine.tracer.events())} events)")
    if args.metrics:
        from repro_torch.obs import MetricsRegistry, bind_engine_metrics
        reg = MetricsRegistry()
        bind_engine_metrics(reg, engine)
        print(reg.render(), end="")


if __name__ == "__main__":
    main()
