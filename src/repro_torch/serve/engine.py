"""``RalmEngine`` — the generation loop (twin of ``repro.serve.engine``,
monolithic wave path).

One wave step, driven by the scheduler:

  * ``dispatch_wave`` — ONE ``decode_wave`` over the slotted
    ``KVCachePool`` advances every active sequence (step-0 sequences
    consume their prefill outputs instead);
  * ``dispatch_search_wave`` + ``flush_searches`` — every due row's
    query goes to the retriever; an ``AsyncRetriever`` coalesces the
    wave into one batched probe + scan + merge;
  * ``finish_wave`` — one payload resolve + kNN-LM interpolation over
    the due rows, one greedy argmax over the greedy rows.

The step-0 retrieval query is the prefill's last-position hidden state.
Speculative retrieval, the disaggregated backend, the tracer and the
per-sequence decode loop are later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import rag as rag_lib
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.rag import RagConfig
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.retrieval.service import ServiceConfig
from repro_torch.serve.api import (EngineConfig, RalmRequest, RalmResponse,
                                   Retriever)
from repro_torch.serve.kvpool import KVCachePool, next_pow2
from repro_torch.serve.scheduler import RalmScheduler


@torch.no_grad()
def _prefill(params, cfg: ModelConfig, rag: RagConfig, prompt: torch.Tensor,
             max_seq: int):
    """Consume the prompt. Returns (caches, last_logits [B, V],
    last_hidden [B, d]); the last hidden state is the step-0 query."""
    B, _ = prompt.shape
    caches = tf.init_cache(cfg, B, max_seq=max_seq, device=prompt.device)
    logits, caches, hidden = tf.forward(params, cfg, prompt, mode="prefill",
                                        caches=caches, return_hidden=True)
    return caches, logits[:, -1], hidden[:, -1]


class MonolithicBackend:
    """Decode on one device — LM and retrieval share it."""

    def __init__(self, params, cfg: ModelConfig):
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.decode_dispatches = 0      # LM wave steps issued

    def prefill(self, rag: RagConfig, prompt: torch.Tensor, max_seq: int):
        return _prefill(self.params, self.cfg, rag, prompt, max_seq)

    def decode_wave(self, caches, token, slots, position, kv_len=None):
        """Advance one wave of pooled slots: token/slots/position [W]."""
        self.decode_dispatches += 1
        return tf.decode_wave(self.params, self.cfg, caches, token, slots,
                              position, return_hidden=True, kv_len=kv_len)


@dataclasses.dataclass
class SequenceState:
    """One active request's decode state; its KV lives in the engine's
    pool at rows ``slots`` (one per prompt row)."""
    request: RalmRequest
    out: List[torch.Tensor]
    cur: torch.Tensor                    # [B, 1] last sampled token
    t0: int                              # prompt length
    logits0: Optional[torch.Tensor]      # prefill logits (consumed at s=0)
    hidden0: Optional[torch.Tensor]      # prefill hidden (step-0 query)
    rng: Optional[torch.Generator]
    step: int = 0
    slots: Optional[np.ndarray] = None

    @property
    def done(self) -> bool:
        return self.step >= self.request.steps

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
                 max_active: Optional[int] = None,
                 kv_slots: Optional[int] = None, attn_seq_block: int = 16):
        """``kv_slots`` fixes the pool capacity in rows (admission defers
        until completions free slots; ``None`` grows on demand).
        ``attn_seq_block`` is the pool's seq-axis quantum: each wave's
        attention reads crop to the block-aligned valid prefix."""
        self.backend = backend
        self.retriever = retriever
        self.rag = rag if rag is not None else RagConfig(mode="none")
        self.cfg = backend.cfg
        self.device = backend.device
        self.max_seq = max_seq
        self.kv_slots = kv_slots
        self.attn_seq_block = attn_seq_block
        self.pool: Optional[KVCachePool] = None   # built at first admission
        self.scheduler = RalmScheduler(self, max_active=max_active)
        self._unclaimed: List[RalmResponse] = []

    @property
    def decode_dispatches(self) -> int:
        """LM wave steps issued so far."""
        return self.backend.decode_dispatches

    # -- constructors -------------------------------------------------------

    @classmethod
    def monolithic(cls, params, cfg: ModelConfig, rag: RagConfig,
                   retriever: Optional[Retriever] = None,
                   max_seq: Optional[int] = None,
                   kv_slots: Optional[int] = None,
                   attn_seq_block: int = 16) -> "RalmEngine":
        """An engine on the device the ``params`` live on."""
        return cls(MonolithicBackend(params, cfg), retriever, rag,
                   max_seq=max_seq, kv_slots=kv_slots,
                   attn_seq_block=attn_seq_block)

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
        if config.async_retrieval:
            retriever = datastore.async_retriever(
                search_cfg, query_proj=query_proj,
                service_cfg=ServiceConfig(measure=config.retrieval_measure))
        else:
            retriever = datastore.retriever(search_cfg, query_proj=query_proj)
        eng = cls.monolithic(params, config.model, config.rag,
                             retriever=retriever, max_seq=config.max_seq,
                             kv_slots=config.kv_slots,
                             attn_seq_block=config.attn_seq_block)
        eng.scheduler.max_active = config.max_active
        return eng

    # -- KV-cache pool admission -------------------------------------------

    def check_admissible(self, request: RalmRequest) -> None:
        """A request that can never fit the fixed pool fails at submit."""
        if self.kv_slots is not None and \
                request.prompt.shape[0] > self.kv_slots:
            raise ValueError(
                f"request batch of {request.prompt.shape[0]} rows can "
                f"never fit kv_slots={self.kv_slots}")

    def can_admit(self, request: RalmRequest) -> bool:
        if self.kv_slots is None:
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
        pool = self.pool
        if self.max_seq is None and need_seq > pool.max_seq:
            pool.grow_seq(need_seq)
        if pool.num_free < rows:
            pool.grow_slots(max(pool.capacity * 2,
                                next_pow2(pool.num_used + rows)))
        return pool

    def release(self, seq: SequenceState) -> None:
        """Return a finished sequence's slot rows to the pool."""
        if seq.slots is not None and self.pool is not None:
            self.pool.release(seq.slots)
            seq.slots = None

    # -- the wave step (called by the scheduler) ----------------------------

    def start(self, request: RalmRequest) -> SequenceState:
        """Prefill a request into pool slots: claim one slot per prompt
        row, prefill at the pool's ``max_seq``, copy the rows in."""
        prompt = torch.as_tensor(request.prompt).to(self.device, torch.int32)
        B, T0 = prompt.shape
        request.times.admit = time.perf_counter()
        pool = self._ensure_pool(B, T0 + request.steps)
        slots = pool.alloc(B)
        caches, logits0, hidden0 = self.backend.prefill(self.rag, prompt,
                                                        pool.max_seq)
        pool.write_prefill(slots, caches)
        return SequenceState(request=request, out=[prompt],
                             cur=prompt[:, -1:], t0=T0, logits0=logits0,
                             hidden0=hidden0, rng=request.rng, slots=slots)

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
    def dispatch_wave(self, seqs: List[SequenceState]
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """ONE ``decode_wave`` for every step>0 sequence; returns each
        sequence's (logits [B, V], hidden [B, d])."""
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
        tokens, slots, positions = pool.pad_wave(tokens, slots, positions)
        kv_len = pool.attn_len(max_pos, bucket=len(slots))
        logits, pool.caches, hidden = self.backend.decode_wave(
            pool.caches, tokens, self._to_device(slots),
            self._to_device(positions), kv_len=kv_len)
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
            for i in due:
                searches[i] = submit(decoded[i][1])
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
        """One resolve + one kNN-LM interpolation over the due rows, one
        greedy argmax over the greedy rows; sampled rows draw from their
        own request's generator, on that generator's device (a CUDA
        generator keeps the draw on the card, a CPU one moves the row's
        probabilities to the host)."""
        rag = self.rag
        rows: List[torch.Tensor] = []
        knn = []                # (row index, logits, dists, ids)
        for seq, (logits, _), search in zip(seqs, decoded, searches):
            if search is not None:
                dists, ids = (search.result() if hasattr(search, "result")
                              else search)
                if seq.request.trace is not None:
                    seq.request.trace.append(
                        dict(step=seq.step, ids=ids.cpu().numpy()))
                if rag.mode == "knnlm":
                    knn.append((len(rows), logits, dists, ids))
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

    def _emit(self, seq: SequenceState, nxt: torch.Tensor) -> None:
        seq.cur = nxt[:, None]
        seq.out.append(seq.cur)
        if seq.request.times.first_token is None:
            seq.request.times.first_token = time.perf_counter()
        seq.step += 1

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
