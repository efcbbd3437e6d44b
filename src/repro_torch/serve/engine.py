"""``RalmEngine`` — the generation loop (twin of ``repro.serve.engine``,
monolithic backend).

Decode has two shapes. The default (``wave=True``) runs one wave step
per scheduler step:

  * ``dispatch_wave`` — ONE ``decode_wave`` over the slotted
    ``KVCachePool`` advances every active sequence (step-0 sequences
    consume their prefill outputs instead);
  * ``dispatch_search_wave`` + ``flush_searches`` — every due row's
    query goes to the retriever; an ``AsyncRetriever`` coalesces the
    wave into one batched probe + scan + merge;
  * ``finish_wave`` — one payload resolve + kNN-LM interpolation over
    the due rows (RETRO: one chunk resolve + one re-encode over the due
    rows, whose encoder states the pool keeps for the next waves), one
    greedy argmax over the greedy rows.

The per-sequence loop (``wave=False``, ``EngineConfig.wave_decode=False``)
is the reference's parity oracle: each request keeps its own caches
[B, S, KV, D] and advances through ``dispatch_decode`` (one
``decode_step`` per request), ``dispatch_search`` and ``finish_step``.
Greedy tokens are the same on both paths.

The step-0 retrieval query is the prefill's last-position hidden state.
An encoder-decoder prefills against neutral encoder states (PAD chunks),
and each retrieval replaces them with the encoding of the retrieved
chunks; the decoder's cross K/V are recomputed from them every step.

Serving surface: a request with an ``on_token`` consumer gets its tokens
on the host once a wave (``_emit``), and its ``first_token`` time is
stamped after that sync; without one it is stamped when the wave is
enqueued. ``RalmScheduler.cancel`` flags a request, which then finishes
at the next step (``SequenceState.done``) and drops its speculation
points unverified.

Speculative retrieval (RaLMSpec, arXiv 2401.14021; ``speculate_k > 0``):
a due greedy row decodes ahead on its last verified neighbours (or a
stale cache entry) while its real search is in flight;
``spec_harvest`` verifies it 1..k waves later by re-mixing the saved
logits with the real neighbours, and a mismatch rolls the sequence back
(``KVCachePool.rewind``) and replays it, so greedy tokens equal the
tokens with speculation off.

Observability: ``set_tracer`` (or ``EngineConfig.trace``) installs a
``repro_torch.obs.Tracer`` in the engine, its scheduler, retrieval
service and KV pool; ``write_trace`` dumps it as Chrome trace-event
JSON. The spans are host wall time: on the card a span covers the device
work inside it only where that code waits for the device.

Fault tolerance: ``EngineConfig.shard_replicas`` /
``retrieval_deadline_s`` / ``chaos_plan`` arm the retrieval service's
fault-tolerant dispatch (``retrieval/replica.py``, ``retrieval/chaos.py``);
a step served from a partial result counts in the response's
``partial_steps``. The disaggregated backend is a later slice.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import rag as rag_lib
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.rag import RagConfig
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.retrieval.replica import FailoverConfig
from repro_torch.retrieval.service import ServiceConfig
from repro_torch.retrieval.stats import RetrievalStats
from repro_torch.serve.api import (EngineConfig, RalmRequest, RalmResponse,
                                   Retriever)
from repro_torch.serve.kvpool import KVCachePool, next_pow2
from repro_torch.serve.scheduler import RalmScheduler


@torch.no_grad()
def _prefill(params, cfg: ModelConfig, rag: RagConfig, prompt: torch.Tensor,
             max_seq: int):
    """Consume the prompt. Returns (caches, enc_states, last_logits
    [B, V], last_hidden [B, d]); the last hidden state is the step-0
    query. An encoder-decoder gets neutral encoder states: the encoding
    of PAD chunks, ``max(k * chunk_len, 8)`` wide under RETRO (8
    otherwise); a decoder gets None. Under M-RoPE the prompt's
    positions are three equal streams [3, B, T] (text)."""
    B, T0 = prompt.shape
    caches = tf.init_cache(cfg, B, max_seq=max_seq, device=prompt.device)
    enc_states = None
    if cfg.arch == "encdec":
        enc_len = rag.k * rag.chunk_len if rag.mode == "retro" else 0
        neutral = torch.zeros((B, max(enc_len, 8)), dtype=torch.int32,
                              device=prompt.device)
        enc_states = tf.encode(params, cfg, tf.embed_tokens(params, neutral))
    pos = torch.arange(T0, device=prompt.device)[None].expand(B, T0)
    if cfg.rope_mode == "mrope":
        pos = pos[None].expand(3, B, T0)
    logits, caches, hidden = tf.forward(params, cfg, prompt, positions=pos,
                                        mode="prefill", caches=caches,
                                        return_hidden=True,
                                        enc_states=enc_states)
    return caches, enc_states, logits[:, -1], hidden[:, -1]


class MonolithicBackend:
    """Decode on one device — LM and retrieval share it."""

    def __init__(self, params, cfg: ModelConfig):
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.decode_dispatches = 0      # LM steps issued (waves, or one
        #                                 per request per step when the
        #                                 engine runs per sequence)

    def prefill(self, rag: RagConfig, prompt: torch.Tensor, max_seq: int):
        return _prefill(self.params, self.cfg, rag, prompt, max_seq)

    def decode(self, caches, token, position, enc_states=None):
        """Advance one request over its own caches: token [B, 1],
        position [B] (the per-sequence loop)."""
        self.decode_dispatches += 1
        return tf.decode_step(self.params, self.cfg, caches, token, position,
                              return_hidden=True, enc_states=enc_states)

    def decode_wave(self, caches, token, slots, position, kv_len=None,
                    enc_states=None):
        """Advance one wave of pooled slots: token/slots/position [W];
        ``enc_states`` [W, S, d] are the wave's encoder rows."""
        self.decode_dispatches += 1
        return tf.decode_wave(self.params, self.cfg, caches, token, slots,
                              position, return_hidden=True, kv_len=kv_len,
                              enc_states=enc_states)

    @torch.no_grad()
    def encode_chunks(self, chunks: torch.Tensor) -> torch.Tensor:
        """RETRO re-encode of retrieved chunk tokens [B, L] -> encoder
        states [B, L, d]."""
        return tf.encode(self.params, self.cfg,
                         tf.embed_tokens(self.params, chunks))


@dataclasses.dataclass
class SpecPoint:
    """One outstanding speculation: a retrieval-due step that decoded
    ahead on stale neighbours while the real search runs.

    Everything needed to verify later, and to roll back on a mismatch,
    is captured at emit time: the pre-interpolation LM logits (so the
    verification mix is the one the baseline would have computed), the
    token emitted from the stale mix, and the ``seq.out`` length before
    that emit (the truncation watermark)."""
    step: int                      # the due step that speculated
    handle: Any                    # SearchHandle of the real search
    logits: torch.Tensor           # [B, V] LM logits at `step`
    emitted: torch.Tensor          # [B, 1] token emitted from the stale mix
    out_len: int                   # len(seq.out) BEFORE the emit
    age: int = 0                   # waves since issue; verified when it
    #                                reaches the speculation depth


class _SpecIssue:
    """Marker for a speculated row: ``finish_wave`` mixes the stale
    ``(dists, ids)`` instead of waiting on ``handle`` (the real search,
    resolved by ``spec_harvest`` 1..k waves later)."""

    __slots__ = ("handle", "dists", "ids")

    def __init__(self, handle, dists, ids):
        self.handle = handle
        self.dists = dists
        self.ids = ids


@dataclasses.dataclass
class SequenceState:
    """One active request's decode state. Wave mode: its KV (and an
    encoder-decoder's encoder states) live in the engine's pool at rows
    ``slots`` (one per prompt row) and ``caches`` / ``enc_states`` are
    None; per-sequence mode: ``caches`` and ``enc_states`` are its
    own."""
    request: RalmRequest
    out: List[torch.Tensor]
    cur: torch.Tensor                    # [B, 1] last sampled token
    t0: int                              # prompt length
    logits0: Optional[torch.Tensor]      # prefill logits (consumed at s=0)
    hidden0: Optional[torch.Tensor]      # prefill hidden (step-0 query)
    rng: Optional[torch.Generator]
    step: int = 0
    slots: Optional[np.ndarray] = None
    caches: Any = None
    enc_states: Optional[torch.Tensor] = None
    last_neighbors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    #                                      most recent VERIFIED (dists,
    #                                      ids): the stale neighbours the
    #                                      next due step speculates with
    spec_points: List[SpecPoint] = dataclasses.field(default_factory=list)
    wave_shapes: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)            # step -> (bucket, kv_len) of the
    #                                      wave that decoded it
    search_rows: Dict[int, int] = dataclasses.field(default_factory=dict)
    #                                      step -> rows its search flush
    #                                      was submitted with (both kept
    #                                      only while speculating, for
    #                                      rollback replays)

    @property
    def done(self) -> bool:
        return self.request.cancelled or self.step >= self.request.steps

    def tokens(self) -> torch.Tensor:
        return torch.cat(self.out, dim=1)


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class RalmEngine:
    """One decode backend + one ``Retriever`` + the canonical step."""

    def __init__(self, backend: MonolithicBackend,
                 retriever: Optional[Retriever] = None,
                 rag: Optional[RagConfig] = None,
                 max_seq: Optional[int] = None,
                 max_active: Optional[int] = None, wave: bool = True,
                 kv_slots: Optional[int] = None, attn_seq_block: int = 16,
                 speculate_k: int = 0, speculate_verify: bool = True):
        """``wave=True`` decodes every active request in one dispatch per
        scheduler step over a slotted ``KVCachePool``; ``wave=False``
        keeps the per-sequence loop (one decode per request, private
        caches). ``kv_slots`` fixes the pool capacity in rows (admission
        defers until completions free slots; ``None`` grows on demand).
        ``attn_seq_block`` is the pool's seq-axis quantum: each wave's
        attention reads crop to the block-aligned valid prefix.
        ``speculate_k`` is the speculation depth (0 = off) and
        ``speculate_verify`` whether speculated tokens are verified and
        rolled back (see ``EngineConfig``)."""
        self.backend = backend
        self.retriever = retriever
        self.rag = rag if rag is not None else RagConfig(mode="none")
        self.cfg = backend.cfg
        self.device = backend.device
        if wave and self.rag.mode == "retro" and \
                self.cfg.arch == "encdec" and \
                self.rag.k * self.rag.chunk_len < 8:
            # the pooled enc buffer has one width for every slot, but
            # prefill's neutral encoder rows are at least 8 wide while a
            # re-encode's are k * chunk_len: fail here, not mid-run
            raise ValueError(
                f"wave decode needs rag.k * rag.chunk_len >= 8 for RETRO "
                f"(got {self.rag.k} * {self.rag.chunk_len}); use "
                "wave=False for this config")
        self.max_seq = max_seq
        self.wave = wave
        self.kv_slots = kv_slots
        self.attn_seq_block = attn_seq_block
        # -- speculative retrieval (RaLMSpec, arXiv 2401.14021) --------
        self.speculate_k = int(speculate_k)
        self.speculate_verify = speculate_verify
        if self.speculate_k > 0 and not wave:
            warnings.warn(
                "speculate_k > 0 requires wave decode (the per-sequence "
                "loop is the thing speculation verifies against) — "
                "disabling speculation.", RuntimeWarning, stacklevel=2)
            self.speculate_k = 0
        elif self.speculate_k > 0 and (self.cfg.ssm_state > 0 or
                                       self.cfg.block in ("rwkv6",
                                                          "hybrid")):
            warnings.warn(
                f"speculate_k > 0 is unsupported for recurrent-state "
                f"blocks (block={self.cfg.block!r}, ssm_state="
                f"{self.cfg.ssm_state}): the state update cannot be "
                "rewound on rollback — disabling speculation.",
                RuntimeWarning, stacklevel=2)
            self.speculate_k = 0
        # verification depth in waves. Ring (sliding-window) caches alias
        # KV positions modulo the window, so only a depth-1 rollback
        # rewrites exactly the slots it invalidated: deeper speculation
        # is clamped for windowed models (see KVCachePool.rewind).
        self._spec_depth = self.speculate_k
        if self.speculate_k > 0 and self.cfg.window > 0 and \
                "local" in self.cfg.pattern_classes():
            self._spec_depth = 1
        self._local_spec_stats: Optional[RetrievalStats] = None
        self.pool: Optional[KVCachePool] = None   # built at first admission
        self.scheduler = RalmScheduler(self, max_active=max_active)
        self._unclaimed: List[RalmResponse] = []
        self.tracer = NULL_TRACER      # set_tracer swaps a live one in
        self.trace_path: Optional[str] = None

    # -- observability ------------------------------------------------------

    def set_tracer(self, tracer: Tracer) -> None:
        """Install a tracer in the engine and every component with a span
        site: the retrieval service (queue wait, scan, merge, gather,
        hedge / partial / eject / recover instants) and the KV pool
        (alloc / release / rewind). The lazily built pool picks it up at
        construction."""
        self.tracer = tracer
        service = getattr(self.retriever, "service", None)
        if service is not None:
            service.tracer = tracer
        if self.pool is not None:
            self.pool.tracer = tracer

    def write_trace(self, path: Optional[str] = None) -> str:
        """Dump the trace buffer as Chrome trace-event JSON. ``path``
        defaults to ``EngineConfig.trace_path`` or ``trace.json``."""
        path = path or self.trace_path or "trace.json"
        self.tracer.write(path)
        return path

    @property
    def decode_dispatches(self) -> int:
        """LM steps issued so far (wave mode: one per wave)."""
        return self.backend.decode_dispatches

    # -- constructors -------------------------------------------------------

    @classmethod
    def monolithic(cls, params, cfg: ModelConfig, rag: RagConfig,
                   retriever: Optional[Retriever] = None,
                   max_seq: Optional[int] = None, wave: bool = True,
                   kv_slots: Optional[int] = None,
                   attn_seq_block: int = 16, speculate_k: int = 0,
                   speculate_verify: bool = True) -> "RalmEngine":
        """An engine on the device the ``params`` live on."""
        return cls(MonolithicBackend(params, cfg), retriever, rag,
                   max_seq=max_seq, wave=wave, kv_slots=kv_slots,
                   attn_seq_block=attn_seq_block, speculate_k=speculate_k,
                   speculate_verify=speculate_verify)

    @classmethod
    def from_config(cls, config: EngineConfig, params, datastore,
                    search_cfg: ChamVSConfig,
                    query_proj: Optional[torch.Tensor] = None,
                    device=None) -> "RalmEngine":
        """Stand an engine up from an ``EngineConfig`` and a built
        ``Datastore``, on ``device`` — the GPU when ``None`` (raises when
        there is none). Params and datastore are moved there."""
        dev = device_lib.resolve(device)
        params = _to_device(params, dev)
        datastore = datastore.to(dev)
        if query_proj is not None:
            query_proj = query_proj.to(dev)
        if config.retrieval_cache > 0 and not config.async_retrieval:
            warnings.warn(
                "EngineConfig.retrieval_cache requires "
                "async_retrieval=True (the cache lives in the "
                "RetrievalService) — ignoring it.", RuntimeWarning,
                stacklevel=2)
        speculate_k = config.speculate_k
        if speculate_k > 0 and not config.async_retrieval:
            warnings.warn(
                "EngineConfig.speculate_k requires "
                "async_retrieval=True (speculation hides the "
                "RetrievalService's async scan behind decode; a "
                "synchronous retriever has nothing to hide) — "
                "disabling speculation.", RuntimeWarning, stacklevel=2)
            speculate_k = 0
        ft_wanted = (config.shard_replicas > 1 or
                     config.retrieval_deadline_s > 0.0 or
                     config.chaos_plan is not None)
        if ft_wanted and not config.async_retrieval:
            warnings.warn(
                "EngineConfig retrieval fault-tolerance knobs "
                "(shard_replicas / retrieval_deadline_s / chaos_plan) "
                "require async_retrieval=True (the dispatch loop "
                "lives in the RetrievalService) — ignoring them.",
                RuntimeWarning, stacklevel=2)
        if config.async_retrieval:
            failover = None
            if ft_wanted:
                failover = FailoverConfig(
                    replicas=max(1, config.shard_replicas),
                    dispatch_deadline_s=config.retrieval_deadline_s,
                    hedge_quantile=config.hedge_quantile)
            retriever = datastore.async_retriever(
                search_cfg, query_proj=query_proj,
                service_cfg=ServiceConfig(
                    cache_entries=config.retrieval_cache,
                    measure=config.retrieval_measure, failover=failover))
            if config.chaos_plan is not None:
                retriever.service.install_chaos(config.chaos_plan)
        else:
            retriever = datastore.retriever(search_cfg, query_proj=query_proj)
        eng = cls.monolithic(params, config.model, config.rag,
                             retriever=retriever, max_seq=config.max_seq,
                             wave=config.wave_decode,
                             kv_slots=config.kv_slots,
                             attn_seq_block=config.attn_seq_block,
                             speculate_k=speculate_k,
                             speculate_verify=config.speculate_verify)
        eng.scheduler.max_active = config.max_active
        if config.trace:
            eng.set_tracer(Tracer(enabled=True))
        eng.trace_path = config.trace_path
        return eng

    # -- KV-cache pool admission -------------------------------------------

    def check_admissible(self, request: RalmRequest) -> None:
        """A request that can never fit the fixed pool fails at submit."""
        if self.wave and self.kv_slots is not None and \
                request.prompt.shape[0] > self.kv_slots:
            raise ValueError(
                f"request batch of {request.prompt.shape[0]} rows can "
                f"never fit kv_slots={self.kv_slots}")

    def can_admit(self, request: RalmRequest) -> bool:
        if not self.wave or self.kv_slots is None:
            return True
        return self.pool is None or \
            self.pool.num_free >= request.prompt.shape[0]

    def _ensure_pool(self, rows: int, need_seq: int) -> KVCachePool:
        """Create the pool lazily, and grow it (slot rows double, the
        sequence axis extends) when an admission needs more."""
        if self.pool is None:
            cap = (self.kv_slots if self.kv_slots is not None
                   else max(next_pow2(rows), 8))
            self.pool = KVCachePool(self.cfg, cap, self.max_seq or need_seq,
                                    fixed=self.kv_slots is not None,
                                    seq_block=self.attn_seq_block,
                                    device=self.device)
            self.pool.tracer = self.tracer
        pool = self.pool
        if self.max_seq is None and need_seq > pool.max_seq:
            pool.grow_seq(need_seq)
        if pool.num_free < rows:
            pool.grow_slots(max(pool.capacity * 2,
                                next_pow2(pool.num_used + rows)))
        return pool

    def release(self, seq: SequenceState) -> None:
        """Return a finished sequence's slot rows to the pool (or drop its
        own caches, per sequence). The scheduler settles speculation
        points (``spec_finalize``) first; any left here are discarded
        unverified."""
        if seq.spec_points:
            stats = self.spec_stats
            for p in seq.spec_points:
                p.handle.cancel()
                stats.spec_discarded += 1
            seq.spec_points.clear()
        if seq.slots is not None and self.pool is not None:
            self.pool.release(seq.slots)
            seq.slots = None
        seq.caches = seq.enc_states = None

    # -- the step (called by the scheduler) ---------------------------------

    def start(self, request: RalmRequest) -> SequenceState:
        """Prefill a request. Wave mode: claim one pool slot per prompt
        row, prefill at the pool's ``max_seq``, copy the rows in. Per
        sequence: prefill into the request's own caches. The prompt may
        arrive on the host (the gateway builds it there); it moves to the
        engine's device here, on the thread that runs the scheduler."""
        prompt = torch.as_tensor(request.prompt).to(self.device, torch.int32)
        B, T0 = prompt.shape
        request.times.admit = time.perf_counter()
        tr = self.tracer
        if tr.enabled:
            # retroactive span: the wait began at submit(); then the flow
            # arrow to the wave that produces the first token (_emit)
            args = {"request_id": request.request_id,
                    "trace_id": request.trace_id, "tenant": request.tenant,
                    "rows": B}
            if request.times.arrival is not None:
                tr.complete("queue.wait", "requests", request.times.arrival,
                            request.times.admit - request.times.arrival,
                            args=args)
            if request.trace_id is not None:
                tr.flow_start(request.trace_id)
        with tr.span("sched.admit", "requests",
                     args={"request_id": request.request_id, "rows": B,
                           "prompt_len": T0} if tr.enabled else None):
            if not self.wave:
                caches, enc_states, logits0, hidden0 = self.backend.prefill(
                    self.rag, prompt, self.max_seq or (T0 + request.steps))
                return SequenceState(request=request, out=[prompt],
                                     cur=prompt[:, -1:], t0=T0,
                                     logits0=logits0, hidden0=hidden0,
                                     rng=request.rng, caches=caches,
                                     enc_states=enc_states)
            pool = self._ensure_pool(B, T0 + request.steps)
            slots = pool.alloc(B)
            caches, enc_states, logits0, hidden0 = self.backend.prefill(
                self.rag, prompt, pool.max_seq)
            pool.write_prefill(slots, caches)
            if enc_states is not None:
                pool.write_enc(slots, enc_states)
        return SequenceState(request=request, out=[prompt],
                             cur=prompt[:, -1:], t0=T0, logits0=logits0,
                             hidden0=hidden0, rng=request.rng, slots=slots)

    # -- the per-sequence loop (wave=False) ---------------------------------

    @torch.no_grad()
    def dispatch_decode(self, seq: SequenceState
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One LM step for one request over its own caches. At step 0 the
        prefill already produced the logits and the query."""
        if seq.step == 0:
            logits, hidden = seq.logits0, seq.hidden0
            seq.logits0 = seq.hidden0 = None
            return logits, hidden
        B = seq.cur.shape[0]
        position = torch.full((B,), seq.t0 + seq.step - 1, dtype=torch.int32,
                              device=self.device)
        logits, seq.caches, hidden = self.backend.decode(
            seq.caches, seq.cur, position, enc_states=seq.enc_states)
        return logits, hidden

    def dispatch_search(self, seq: SequenceState, hidden: torch.Tensor):
        """Issue this request's query when retrieval is due: a
        ``SearchHandle`` from an async retriever (flushed with the other
        requests' queries by ``flush_searches``), else None (the
        synchronous retriever searches inside ``finish_step``)."""
        if not self._retrieval_due(seq.step):
            return None
        submit = getattr(self.retriever, "search_async", None)
        return None if submit is None else submit(hidden)

    @torch.no_grad()
    def finish_step(self, seq: SequenceState, logits: torch.Tensor,
                    hidden: torch.Tensor, search=None) -> None:
        """Retrieve (if due), mix, and sample one token for one request;
        ``search`` is the handle ``dispatch_search`` returned, if any."""
        row = logits
        if self._retrieval_due(seq.step):
            if search is not None:
                dists, ids = search.result()
                if search.partial:
                    seq.request.partial_steps += 1
            else:
                dists, ids = self.retriever.search(hidden)
            if seq.request.trace is not None:
                seq.request.trace.append(dict(step=seq.step,
                                              ids=ids.cpu().numpy()))
            if self.rag.mode == "knnlm":
                toks = self.retriever.resolve(ids, kind="tokens")
                row = rag_lib.knnlm_interpolate(logits, dists, toks,
                                                self.rag.lam,
                                                self.rag.temperature)
            elif self.rag.mode == "retro" and self.cfg.arch == "encdec":
                B = seq.cur.shape[0]
                chunks = self.retriever.resolve(ids, kind="chunks")
                seq.enc_states = self.backend.encode_chunks(
                    chunks.reshape(B, -1))
        if seq.request.greedy or seq.rng is None:
            self._emit(seq, torch.argmax(row.float(), dim=-1).to(torch.int32))
            return
        probs = torch.softmax(row.float(), dim=-1)
        draw = torch.multinomial(probs.to(seq.rng.device), 1,
                                 generator=seq.rng)[:, 0]
        self._emit(seq, draw.to(self.device, torch.int32))

    def _retrieval_due(self, step: int) -> bool:
        return (self.retriever is not None and self.rag.mode != "none" and
                rag_lib.should_retrieve(step, self.rag.interval))

    def flush_searches(self) -> None:
        """Coalesce every query issued this wave into one batched search
        (no-op for synchronous retrievers)."""
        flush = getattr(self.retriever, "flush", None)
        if flush is not None:
            flush()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream sync: a copy from
        pageable memory waits for the device to drain its queue, a copy
        from pinned memory does not."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @torch.no_grad()
    def dispatch_wave(self, seqs: List[SequenceState],
                      shape: Optional[Tuple[int, int]] = None
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """ONE ``decode_wave`` for every step>0 sequence; returns each
        sequence's (logits [B, V], hidden [B, d]). ``shape`` = (bucket,
        kv_len) pads the wave to ``bucket`` rows and reads ``kv_len``
        positions instead of the wave's own: a rollback replays a step
        at the shape of the wave that first decoded it, because on the
        card a row's bits can depend on the shape of the wave it runs in
        (``tools/spec_replay_shapes.py``)."""
        outs: List = [None] * len(seqs)
        wave = []
        for i, seq in enumerate(seqs):
            if seq.step == 0:
                outs[i] = (seq.logits0, seq.hidden0)
                seq.logits0 = seq.hidden0 = None
            else:
                wave.append((i, seq))
        if not wave:
            return outs
        pool = self.pool
        tokens = torch.cat([seq.cur for _, seq in wave], dim=0)
        slots = np.concatenate([seq.slots for _, seq in wave])
        positions = np.concatenate(
            [np.full(seq.cur.shape[0], seq.t0 + seq.step - 1, np.int32)
             for _, seq in wave])
        max_pos = int(positions.max())
        if shape is None:
            tokens, slots, positions = pool.pad_wave(tokens, slots,
                                                     positions)
            kv_len = pool.attn_len(max_pos, bucket=len(slots))
        else:
            tokens, slots, positions = pool.pad_wave(
                tokens, slots, positions, bucket=shape[0])
            kv_len = shape[1]
        if self.speculate_k > 0:
            for _, seq in wave:
                seq.wave_shapes[seq.step] = (len(slots), kv_len)
        tr = self.tracer
        with tr.span("wave.decode", "wave",
                     args={"rows": len(wave), "bucket": len(slots),
                           "kv_len": kv_len} if tr.enabled else None):
            logits, pool.caches, hidden = self.backend.decode_wave(
                pool.caches, tokens, self._to_device(slots),
                self._to_device(positions), kv_len=kv_len,
                enc_states=pool.gather_enc(slots))
        off = 0
        for i, seq in wave:
            B = seq.cur.shape[0]
            outs[i] = (logits[off:off + B], hidden[off:off + B])
            off += B
        return outs

    @torch.no_grad()
    def dispatch_search_wave(self, seqs: List[SequenceState],
                             decoded: List) -> List:
        """Issue every due row's query: async retrievers enqueue (flushed
        by ``flush_searches``), synchronous ones get ONE batched
        ``search`` over the wave's due rows."""
        searches: List = [None] * len(seqs)
        due = [i for i, seq in enumerate(seqs)
               if self._retrieval_due(seq.step)]
        if not due:
            return searches
        submit = getattr(self.retriever, "search_async", None)
        if submit is not None:
            rows = sum(decoded[i][1].shape[0] for i in due)
            issued = 0
            for i in due:
                seq = seqs[i]
                if self.speculate_k > 0:
                    seq.search_rows[seq.step] = rows
                if self._spec_eligible(seq):
                    src = self._spec_source(seq, decoded[i][1])
                    if src is not None:
                        # the real search coalesces into this wave's
                        # flush; decode continues on the stale
                        # neighbours; spec_harvest verifies 1..k waves
                        # later
                        searches[i] = _SpecIssue(submit(decoded[i][1]),
                                                 src[0], src[1])
                        self.spec_stats.spec_issued += 1
                        issued += 1
                        continue
                searches[i] = submit(decoded[i][1])
            if issued and self.tracer.enabled:
                self.tracer.instant("spec.issue", "wave",
                                    args={"points": issued})
            return searches
        queries = torch.cat([decoded[i][1] for i in due], dim=0)
        dists, ids = self.retriever.search(queries)
        off = 0
        for i in due:
            B = decoded[i][1].shape[0]
            searches[i] = (dists[off:off + B], ids[off:off + B])
            off += B
        return searches

    @torch.no_grad()
    def finish_wave(self, seqs: List[SequenceState], decoded: List,
                    searches: List) -> None:
        """One resolve + one kNN-LM interpolation over the due rows (RETRO:
        one chunk resolve + one re-encode over the due rows, written to
        their slots' encoder rows), one greedy argmax over the greedy
        rows; sampled rows draw from their own request's generator, on
        that generator's device (a CUDA generator keeps the draw on the
        card, a CPU one moves the row's probabilities to the host)."""
        rag = self.rag
        rows: List[torch.Tensor] = []
        knn = []                # (row index, logits, dists, ids)
        retro = []              # (seq, ids)
        spec_new = []           # (seq, _SpecIssue, logits)
        for seq, (logits, _), search in zip(seqs, decoded, searches):
            if isinstance(search, _SpecIssue):
                # speculated row: mix the STALE neighbours now; the real
                # search stays in flight, and its trace entry waits for
                # verification
                knn.append((len(rows), logits, search.dists, search.ids))
                spec_new.append((seq, search, logits))
            elif search is not None:
                dists, ids = (search.result() if hasattr(search, "result")
                              else search)
                partial = getattr(search, "partial", False)
                if partial:
                    seq.request.partial_steps += 1
                if seq.request.trace is not None:
                    seq.request.trace.append(
                        dict(step=seq.step, ids=ids.cpu().numpy()))
                if rag.mode == "knnlm":
                    knn.append((len(rows), logits, dists, ids))
                    if self.speculate_k > 0 and not partial:
                        # a non-speculated due row refreshes the seed the
                        # NEXT due step speculates with (a partial result
                        # would seed it with degraded neighbours)
                        seq.last_neighbors = (dists, ids)
                elif rag.mode == "retro" and self.cfg.arch == "encdec":
                    retro.append((seq, ids))
            rows.append(logits)
        if knn:
            toks = self.retriever.resolve(
                torch.cat([e[3] for e in knn]), kind="tokens")
            mixed = rag_lib.knnlm_interpolate(
                torch.cat([e[1] for e in knn]), torch.cat([e[2] for e in knn]),
                toks, rag.lam, rag.temperature)
            off = 0
            for idx, logits, _, _ in knn:
                B = logits.shape[0]
                rows[idx] = mixed[off:off + B]
                off += B
        if retro:
            chunks = self.retriever.resolve(
                torch.cat([ids for _, ids in retro]), kind="chunks")
            enc = self.backend.encode_chunks(
                chunks.reshape(chunks.shape[0], -1))
            off = 0
            for seq, _ in retro:
                B = seq.cur.shape[0]
                self.pool.write_enc(seq.slots, enc[off:off + B])
                off += B
        greedy = [i for i, seq in enumerate(seqs)
                  if seq.request.greedy or seq.rng is None]
        if greedy:
            nxt = torch.argmax(torch.cat([rows[i].float() for i in greedy]),
                               dim=-1).to(torch.int32)
            off = 0
            for i in greedy:
                B = rows[i].shape[0]
                self._emit(seqs[i], nxt[off:off + B])
                off += B
        for i, seq in enumerate(seqs):
            if seq.request.greedy or seq.rng is None:
                continue
            probs = torch.softmax(rows[i].float(), dim=-1)
            draw = torch.multinomial(probs.to(seq.rng.device), 1,
                                     generator=seq.rng)[:, 0]
            self._emit(seq, draw.to(self.device, torch.int32))
        # register the wave's speculation points AFTER the emits, so each
        # captures the token it produced and the pre-emit out length
        # (eligibility makes these rows greedy)
        for seq, issue, logits in spec_new:
            seq.spec_points.append(SpecPoint(
                step=seq.step - 1, handle=issue.handle, logits=logits,
                emitted=seq.cur, out_len=len(seq.out) - 1))

    def _emit(self, seq: SequenceState, nxt: torch.Tensor) -> None:
        seq.cur = nxt[:, None]
        seq.out.append(seq.cur)
        req = seq.request
        first = req.times.first_token is None
        if req.on_token is not None:
            # the streaming hook needs the tokens on the host: the first
            # row's copy waits for the wave, the rest are free. The first
            # token is stamped after that wait, so TTFT measures token
            # availability, not the enqueue.
            host = nxt.cpu().numpy()
            if first:
                req.times.first_token = time.perf_counter()
            req.on_token(seq.step, host)
        elif first:
            req.times.first_token = time.perf_counter()
        if first and req.trace_id is not None and self.tracer.enabled:
            # close the flow arrow opened at admission (start)
            self.tracer.flow_end(req.trace_id, track="wave",
                                 t_s=req.times.first_token)
        seq.step += 1

    # -- speculative retrieval (RaLMSpec, arXiv 2401.14021) -----------------

    @property
    def spec_stats(self) -> RetrievalStats:
        """Where speculation counters land: the retrieval service's
        ``RetrievalStats`` when there is one, else a local instance."""
        service = getattr(self.retriever, "service", None)
        if service is not None:
            return service.stats
        if self._local_spec_stats is None:
            self._local_spec_stats = RetrievalStats()
        return self._local_spec_stats

    def _spec_eligible(self, seq: SequenceState) -> bool:
        """Per-row speculation gate, evaluated at each due step (the
        degrade ladder changes ``rag`` between waves): greedy kNN-LM rows
        only (sampling consumes generator state a rollback cannot
        restore), no streaming consumer (``on_token`` would already have
        seen the tokens a rollback retracts), at most ``speculate_k``
        points outstanding."""
        req = seq.request
        return (self.speculate_k > 0
                and self.rag.mode == "knnlm"
                and (req.greedy or seq.rng is None)
                and req.on_token is None
                and len(seq.spec_points) < self.speculate_k)

    def _spec_source(self, seq: SequenceState, hidden: torch.Tensor):
        """The stale neighbours to decode ahead with: the sequence's last
        verified result, else a stale-tolerant cache probe (a seed from
        another request), else None (the row searches and waits, and
        seeds the next due step)."""
        if seq.last_neighbors is not None:
            return seq.last_neighbors
        lookup = getattr(self.retriever, "stale_lookup", None)
        if lookup is not None:
            return lookup(hidden)
        return None

    @torch.no_grad()
    def spec_harvest(self, seqs: List[SequenceState],
                     decoded: Optional[List] = None,
                     force: bool = False) -> None:
        """Verify the speculation points whose real search has had
        ``_spec_depth`` waves to land (all of them under ``force``).

        Verification compares *emitted tokens*: each point's saved LM
        logits are mixed with the REAL neighbours through the same
        operations as ``finish_wave`` (``knnlm_interpolate``, ``.float()``,
        ``argmax``) and the result is compared with the token the stale
        mix emitted. A match accepts; a mismatch rolls back and replays
        (``_spec_rollback``). ``spec_wait`` times only the wait for the
        search results, through each entry's landed event: the decode
        wave enqueued after the scan is not waited for. The comparison
        then costs one host sync per harvest."""
        pts: List[Tuple[Optional[int], SequenceState, SpecPoint]] = []
        for idx, seq in enumerate(seqs):
            if not seq.spec_points:
                continue
            for p in seq.spec_points:
                p.age += 1
            take = 0
            for p in seq.spec_points:
                if force or p.age >= self._spec_depth:
                    take += 1
                else:
                    break
            for p in seq.spec_points[:take]:
                pts.append((idx if decoded is not None else None, seq, p))
            del seq.spec_points[:take]
        if not pts:
            return
        tr = self.tracer
        with tr.span("spec.verify", "wave",
                     args={"points": len(pts), "force": force}
                     if tr.enabled else None):
            self._spec_verify(pts, decoded)

    def _spec_verify(self, pts: List[Tuple[Optional[int], SequenceState,
                                           SpecPoint]],
                     decoded: Optional[List]) -> None:
        """The body of ``spec_harvest``, over the points it took."""
        stats = self.spec_stats
        rag = self.rag
        t0 = time.perf_counter()
        res = [p.handle.result() for _, _, p in pts]
        stats.spec_landed += sum(p.handle.is_ready() for _, _, p in pts)
        for _, _, p in pts:
            p.handle.wait()
        stats.spec_wait.add(time.perf_counter() - t0)
        partials = [p.handle.partial for _, _, p in pts]
        for (_, seq, _), part in zip(pts, partials):
            if part:
                # the point still settles against the sentinel, but the
                # result is not a speculation seed
                stats.ft_spec_flushed += 1
                seq.request.partial_steps += 1
        if not self.speculate_verify:
            # trust-the-stale mode: adopt the real neighbours as the next
            # seed, never compare, never roll back
            for (_, seq, _), (d, i), part in zip(pts, res, partials):
                if not part:
                    seq.last_neighbors = (d, i)
            return
        # ONE batched mix + argmax + host sync over every point verified
        # this wave
        d_cat = torch.cat([d for d, _ in res])
        i_cat = torch.cat([i for _, i in res])
        logits_cat = torch.cat([p.logits for _, _, p in pts])
        toks = self.retriever.resolve(i_cat, kind="tokens")
        mixed = rag_lib.knnlm_interpolate(logits_cat, d_cat, toks, rag.lam,
                                          rag.temperature)
        nxt_cat = torch.argmax(mixed.float(), dim=-1).to(torch.int32)
        emit_cat = torch.cat([p.emitted[:, 0] for _, _, p in pts])
        nxt_h, emit_h = torch.stack([nxt_cat, emit_cat]).cpu().numpy()
        off = 0
        rolled: set = set()
        for (idx, seq, p), (d, i), part in zip(pts, res, partials):
            B = p.logits.shape[0]
            span = slice(off, off + B)
            off += B
            if id(seq) in rolled:
                # a later point of a sequence that already rolled back
                # this harvest: its query came from the discarded timeline
                stats.spec_discarded += 1
                continue
            stats.spec_verified += 1
            if not part:
                seq.last_neighbors = (d, i)
            if seq.request.trace is not None:
                seq.request.trace.append(dict(step=p.step,
                                              ids=i.cpu().numpy()))
            if np.array_equal(nxt_h[span], emit_h[span]):
                stats.spec_accepted += 1
            else:
                stats.spec_rollbacks += 1
                rolled.add(id(seq))
                self._spec_rollback(seq, p, nxt_cat[span], decoded, idx)

    def _spec_rollback(self, seq: SequenceState, point: SpecPoint,
                       corrected: torch.Tensor, decoded: Optional[List],
                       idx: Optional[int]) -> None:
        """Mismatch: rewind to the speculation point and replay with the
        verified neighbours. The corrected token of the speculated step
        comes from the verification mix; each later step replays as a
        wave of this sequence alone, with a search that waits at due
        steps: the baseline's math on the corrected token stream. Each
        replayed decode (and the redo of the current wave) is padded to
        the bucket and kv_len of the wave that first decoded that step,
        and each replayed search to the rows of that step's flush, so
        that the rows' bits equal the run without speculation."""
        stats = self.spec_stats
        t0 = time.perf_counter()
        cur_step = seq.step
        tr = self.tracer
        with tr.span("spec.rollback", "wave",
                     args={"step": point.step,
                           "depth": cur_step - point.step}
                     if tr.enabled else None):
            self._spec_replay(seq, point, corrected, decoded, idx, cur_step)
        stats.spec_replay.add(time.perf_counter() - t0)

    def _spec_replay(self, seq: SequenceState, point: SpecPoint,
                     corrected: torch.Tensor, decoded: Optional[List],
                     idx: Optional[int], cur_step: int) -> None:
        """The body of ``_spec_rollback``: discard, rewind, replay."""
        stats = self.spec_stats
        # later points' queries and logits came from the discarded
        # timeline: drop them unverified
        for p in seq.spec_points:
            p.handle.cancel()
            stats.spec_discarded += 1
        seq.spec_points.clear()
        # token watermark: truncate to before the speculated emit
        del seq.out[point.out_len:]
        seq.cur = seq.out[-1][:, -1:]
        seq.step = point.step
        if self.pool is not None and seq.slots is not None:
            # KV watermark: the prompt (t0) plus one position per decode
            # step 1..s at t0+s-1, plus the current wave's decode when
            # mid-wave (decoded is not None)
            old_len = seq.t0 + cur_step - (0 if decoded is not None else 1)
            keep_len = seq.t0 + point.step
            if old_len > keep_len:
                self.pool.rewind(seq.slots, keep_len=keep_len,
                                 old_len=old_len)
        self._emit(seq, corrected)
        stats.spec_replayed_steps += 1
        while seq.step < cur_step:
            logits, hidden = self.dispatch_wave(
                [seq], shape=seq.wave_shapes[seq.step])[0]
            row = logits
            if self._retrieval_due(seq.step):
                B = hidden.shape[0]
                pad = seq.search_rows[seq.step] - B
                q = hidden if not pad else torch.cat(
                    [hidden, hidden.new_zeros((pad, hidden.shape[1]))])
                dists, ids = self.retriever.search(q)
                dists, ids = dists[:B], ids[:B]
                seq.last_neighbors = (dists, ids)
                if seq.request.trace is not None:
                    seq.request.trace.append(dict(step=seq.step,
                                                  ids=ids.cpu().numpy()))
                toks = self.retriever.resolve(ids, kind="tokens")
                row = rag_lib.knnlm_interpolate(
                    logits, dists, toks, self.rag.lam, self.rag.temperature)
            self._emit(seq, torch.argmax(row.float(), dim=-1).to(
                torch.int32))
            stats.spec_replayed_steps += 1
        if decoded is not None and idx is not None:
            # mid-wave: this row's output of the current wave came from
            # the wrong token; redo it so finish_wave mixes the right one
            decoded[idx] = self.dispatch_wave(
                [seq], shape=seq.wave_shapes[seq.step])[0]

    def spec_finalize(self, seq: SequenceState) -> None:
        """Settle a finishing sequence's outstanding points before its
        response leaves: a cancelled request discards them (its searches
        are cancelled), a completed one force-verifies them, so the
        response's tokens carry the parity guarantee."""
        if not seq.spec_points:
            return
        if seq.request.cancelled:
            stats = self.spec_stats
            for p in seq.spec_points:
                p.handle.cancel()
                stats.spec_discarded += 1
            seq.spec_points.clear()
            return
        self.spec_harvest([seq], decoded=None, force=True)

    def flush_speculation(self) -> None:
        """Force-verify EVERY outstanding speculation point (before a
        retrieval-quality change: in-flight points verify with the math
        they were issued under)."""
        if self.speculate_k <= 0:
            return
        seqs = [s for s in self.scheduler.active if s.spec_points]
        if seqs:
            self.spec_harvest(seqs, decoded=None, force=True)

    # -- serving API --------------------------------------------------------

    def submit(self, request: RalmRequest) -> int:
        return self.scheduler.submit(request)

    def step(self) -> List[RalmResponse]:
        return self.scheduler.step()

    def run(self) -> List[RalmResponse]:
        """Drain the scheduler, including responses held back by an
        interleaved ``generate()``."""
        out = self._unclaimed + self.scheduler.run()
        self._unclaimed = []
        return out

    def generate(self, prompt, steps: int, *, greedy: bool = True,
                 rng: Optional[torch.Generator] = None,
                 trace: Optional[list] = None) -> np.ndarray:
        """One request, run to completion; other requests' responses are
        held for the next ``run()``."""
        rid = self.submit(RalmRequest(prompt=torch.as_tensor(prompt),
                                      steps=steps, greedy=greedy, rng=rng,
                                      trace=trace))
        result = None
        for resp in self.scheduler.run():
            if resp.request_id == rid:
                result = resp
            else:
                self._unclaimed.append(resp)
        if result is None:
            raise RuntimeError("request did not complete")
        return result.tokens

    def generate_batches(self, prompts: List, steps: int) -> List[np.ndarray]:
        """Several request batches in flight at once; results in submit
        order."""
        rids = [self.submit(RalmRequest(prompt=torch.as_tensor(p),
                                        steps=steps)) for p in prompts]
        by_id = {r.request_id: r.tokens for r in self.run()}
        return [by_id[rid] for rid in rids]
