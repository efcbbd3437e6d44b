"""The serving front door: a streaming HTTP gateway over ``RalmEngine``
(twin of ``repro.serve.gateway.server``).

Chameleon's deployment story (paper §3, §6) is a CPU front-end
multiplexing many concurrent clients over the LM and ChamVS tiers. This
module is that network layer — stdlib-only (``asyncio`` + a minimal
HTTP/1.1 parser, no framework deps), OpenAI-compatible:

    POST /v1/completions   prompt as token ids (or text via the toy
                           byte codec), ``stream: true`` for SSE chunks
                           terminated by ``data: [DONE]``
    GET  /v1/models        the one deployed model
    GET  /healthz          liveness (incl. the step thread)
    GET  /statsz           scheduler queue depths/ages, admission and
                           degrade counters, pool + retrieval + kernel
                           stats, plus a snapshot of the metrics
                           registry (the JSON view of /metricsz)
    GET  /metricsz         Prometheus text exposition of the same
                           registry (repro_torch.obs: TTFT/TPOT/queue-wait
                           histograms with reservoir p50/p95/p99, pool /
                           retrieval / admission / degrade families)
    GET  /tracez           Chrome trace-event JSON export of the
                           engine's tracer buffer (?clear=1 drains it —
                           the per-load-level boundary the loadgen uses)

Architecture — two threads, one engine:

  * the **asyncio event loop** owns all sockets. Handlers parse
    requests, run admission control (429 on quota, 503 + Retry-After
    on queue-depth backpressure — see ``admission.py``), park accepted
    work with the admission controller, and stream tokens out of
    per-request queues;
  * the **step-loop thread** owns the engine and every torch and CUDA
    call (grad mode and the current CUDA stream are per thread; the
    engine's decode and finish methods run under ``no_grad``). Each
    iteration it drains cancellations, releases admitted requests to
    the scheduler in per-tenant fair order (only as many as there are
    free KV rows, so the engine's strict-FIFO inner queue stays
    short), ticks the degradation policy (``degrade.py``), and runs
    one ``scheduler.step()`` — one decode wave + one retrieval wave
    for every active sequence, exactly the batched path the perf PRs
    built. Tokens cross back via ``RalmRequest.on_token`` →
    ``loop.call_soon_threadsafe``.

A mid-stream client disconnect (EOF on the request socket or a failed
chunk write) cancels the request at the next wave: its KV slots are
released and the backlog moves up — a dead client never holds capacity.

The event-loop thread never touches the device: ``_make_request`` builds
the prompt as a CPU int32 tensor, and the engine moves it to its device
in ``start`` on the step thread.

``/statsz``'s ``kernels`` block differs from the reference's: the
reference reports its Pallas-to-ref fallback decisions; the port never
falls back (a CUDA tensor launches its kernel or raises), so the block
reports each CUDA kernel's launch count (``kernels/_build.kernels()``)
instead: ``launches`` by C symbol and their ``launch_total``. On the CPU
every count is 0.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.obs.adapters import bind_gateway_metrics
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.api import RalmRequest
from repro_torch.serve.gateway.admission import (AdmissionController,
                                                 TenantQuota, Verdict)
from repro_torch.serve.gateway.degrade import DegradeConfig, DegradePolicy

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Deployment knobs of one front door."""
    host: str = "127.0.0.1"
    port: int = 0                     # 0 = ephemeral (tests, benches)
    model_id: str = "chameleon-ralm"
    max_queue_depth: int = 64         # 503 bound over the whole pipeline
    default_quota: TenantQuota = TenantQuota()   # unmetered by default
    quotas: Tuple[Tuple[str, TenantQuota], ...] = ()
    degrade: Optional[DegradeConfig] = DegradeConfig()  # None = never shed
    max_tokens_cap: int = 256         # hard cap on requested max_tokens
    max_prompt_tokens: int = 2048     # hard cap on prompt length
    max_body_bytes: int = 1 << 20
    idle_sleep_s: float = 0.005       # step-thread wait when queue empty


@dataclasses.dataclass
class _Stream:
    """Per-in-flight-request bridge between the two threads."""
    rid: int
    tenant: str
    prompt_tokens: int
    max_tokens: int
    queue: "asyncio.Queue" = dataclasses.field(
        default_factory=asyncio.Queue)
    levels: Set[int] = dataclasses.field(default_factory=set)
    tokens: List[int] = dataclasses.field(default_factory=list)


class Gateway:
    """One HTTP front door over one ``RalmEngine``."""

    def __init__(self, engine, config: Optional[GatewayConfig] = None):
        self.engine = engine
        self.scheduler = engine.scheduler
        self.config = config or GatewayConfig()
        self.admission = AdmissionController(
            max_queue_depth=self.config.max_queue_depth,
            default_quota=self.config.default_quota,
            quotas=dict(self.config.quotas))
        self.policy: Optional[DegradePolicy] = (
            DegradePolicy(engine, self.config.degrade)
            if self.config.degrade is not None else None)
        self._lock = threading.Lock()
        self._streams: Dict[int, _Stream] = {}
        self._cancels: deque = deque()
        self._next_rid = 0
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self.port: Optional[int] = None
        self._t_start = time.perf_counter()
        # counters for /statsz and the load harness
        self.completions = 0
        self.cancelled = 0
        self.disconnects = 0
        self.tokens_out = 0
        # observability plane: the engine's tracer (NULL when tracing is
        # off) + one metrics registry absorbing every stats object via
        # scrape-time collectors (repro_torch.obs.adapters)
        self.tracer = getattr(engine, "tracer", NULL_TRACER)
        self.metrics = MetricsRegistry()
        self.ttft_hist = self.metrics.histogram(
            "ralm_ttft_seconds", "time to first token, server-side")
        self.tpot_hist = self.metrics.histogram(
            "ralm_tpot_seconds", "per-output-token time, server-side")
        self.queue_wait_hist = self.metrics.histogram(
            "ralm_queue_wait_seconds", "arrival -> admission wait")
        bind_gateway_metrics(self.metrics, self)

    # ------------------------------------------------------------------
    # step-loop thread: the only thread that touches the engine/torch
    # ------------------------------------------------------------------

    def _free_rows(self) -> Optional[int]:
        eng = self.engine
        if not eng.wave or eng.kv_slots is None:
            return None                       # auto-growing pool
        if eng.pool is None:
            return eng.kv_slots
        return eng.pool.num_free

    def _pump_admissions(self) -> None:
        """Release fair-ordered requests to the scheduler, at most as
        many as fit the free KV rows / ``max_active`` budget, so the
        scheduler's strict-FIFO queue never becomes the bottleneck."""
        free = self._free_rows()
        cap = self.scheduler.max_active
        budget = (None if cap is None else
                  cap - self.scheduler.num_active
                  - self.scheduler.queued_requests)
        while budget is None or budget > 0:
            with self._lock:
                req = self.admission.take(
                    lambda r: free is None or r.prompt.shape[0] <= free)
            if req is None:
                return
            if free is not None:
                free -= req.prompt.shape[0]
            if budget is not None:
                budget -= 1
            self.scheduler.submit(req)

    def _drain_cancels(self) -> None:
        while self._cancels:
            rid = self._cancels.popleft()
            with self._lock:
                dropped = self.admission.cancel(rid)
            if not dropped:
                self.scheduler.cancel(rid)

    def _queue_depth(self) -> int:
        return (self.admission.pending + self.scheduler.queued_requests)

    def _on_token(self, rid: int, step: int, toks: np.ndarray) -> None:
        """Runs on the step thread inside ``finish_wave``: record the
        level this token was produced at, then hand it to the event
        loop. A request whose stream is gone (disconnect) is silently
        dropped here; the cancel lands at the next step."""
        stream = self._streams.get(rid)
        if stream is None:
            return
        if self.policy is not None:
            stream.levels.add(self.policy.level)
        else:
            stream.levels.add(0)
        tok = int(toks[0])
        stream.tokens.append(tok)
        self.tokens_out += 1
        loop = self._loop
        if loop is not None:
            try:
                loop.call_soon_threadsafe(
                    stream.queue.put_nowait, ("tok", step, tok))
            except RuntimeError:       # loop shut down mid-stream
                pass

    def _finish(self, resp) -> None:
        with self._lock:
            stream = self._streams.pop(resp.request_id, None)
        if resp.cancelled:
            self.cancelled += 1
        else:
            self.completions += 1
        times = resp.times
        if times is not None:
            ttft = times.ttft_s()
            if ttft is not None:
                self.ttft_hist.observe(ttft)
            tpot = times.tpot_s(resp.steps)
            if tpot is not None:
                self.tpot_hist.observe(tpot)
            if times.admit is not None and times.arrival is not None:
                self.queue_wait_hist.observe(times.admit - times.arrival)
        if stream is None:
            return
        summary = dict(
            steps=resp.steps,
            cancelled=resp.cancelled,
            degrade_levels=sorted(stream.levels) or [
                self.policy.level if self.policy else 0],
            ttft_ms=(None if times is None or times.ttft_s() is None
                     else times.ttft_s() * 1e3),
            tpot_ms=(None if times is None or times.tpot_s(resp.steps)
                     is None else times.tpot_s(resp.steps) * 1e3),
            queue_wait_ms=(None if times is None or times.admit is None
                           or times.arrival is None
                           else (times.admit - times.arrival) * 1e3),
        )
        loop = self._loop
        if loop is not None:
            try:
                loop.call_soon_threadsafe(
                    stream.queue.put_nowait, ("done", summary))
            except RuntimeError:
                pass

    def _step_loop(self) -> None:
        while not self._stop.is_set():
            self._drain_cancels()
            self._pump_admissions()
            if self.policy is not None:
                self.policy.observe(self._queue_depth())
            if self.scheduler.has_work:
                for resp in self.scheduler.step():
                    self._finish(resp)
            else:
                self._work.wait(timeout=self.config.idle_sleep_s)
                self._work.clear()

    # ------------------------------------------------------------------
    # request intake (runs on the event loop thread)
    # ------------------------------------------------------------------

    def _encode_prompt(self, prompt) -> Optional[List[int]]:
        """OpenAI allows a string or a list of token ids. There is no
        real tokenizer at desk scale, so strings go through a toy byte
        codec (``ord(c) % vocab``) — documented, deterministic, and
        good enough to exercise the serving path."""
        vocab = self.engine.cfg.vocab_size
        if isinstance(prompt, str):
            ids = [ord(c) % vocab for c in prompt]
            return ids or None
        if isinstance(prompt, list) and len(prompt) == 1 and \
                isinstance(prompt[0], list):
            prompt = prompt[0]                 # [[ids]] — a batch of one
        if isinstance(prompt, list) and prompt and \
                all(isinstance(t, int) for t in prompt):
            if any(t < 0 or t >= vocab for t in prompt):
                return None
            return prompt
        return None

    def _make_request(self, body: dict, tenant: str
                      ) -> Tuple[Optional[RalmRequest], str]:
        ids = self._encode_prompt(body.get("prompt"))
        if ids is None:
            return None, ("prompt must be a non-empty string or a list "
                          "of in-vocab token ids")
        if len(ids) > self.config.max_prompt_tokens:
            return None, (f"prompt of {len(ids)} tokens exceeds the "
                          f"{self.config.max_prompt_tokens} cap")
        steps = body.get("max_tokens", 16)
        if not isinstance(steps, int) or steps < 1 or \
                steps > self.config.max_tokens_cap:
            return None, (f"max_tokens must be an int in [1, "
                          f"{self.config.max_tokens_cap}]")
        max_seq = self.engine.max_seq
        if max_seq is not None and len(ids) + steps > max_seq:
            return None, (f"prompt + max_tokens = {len(ids) + steps} "
                          f"exceeds the deployment context of {max_seq}")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        req = RalmRequest(
            prompt=torch.tensor([ids], dtype=torch.int32),
            steps=steps, request_id=rid, tenant=tenant,
            on_token=lambda step, toks, rid=rid:
                self._on_token(rid, step, toks))
        req.times.arrival = time.perf_counter()
        return req, ""

    def _offer(self, req: RalmRequest) -> Verdict:
        in_system = (self.scheduler.queued_requests +
                     self.scheduler.num_active)
        with self._lock:
            verdict = self.admission.offer(req, in_system=in_system)
            if verdict.admitted:
                self._streams[req.request_id] = _Stream(
                    rid=req.request_id, tenant=req.tenant,
                    prompt_tokens=req.prompt.shape[1],
                    max_tokens=req.steps)
        if verdict.admitted:
            self._work.set()
        return verdict

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------

    @staticmethod
    def _head(status: int, ctype: str = "application/json",
              length: Optional[int] = None, extra: str = "") -> bytes:
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
                f"Content-Type: {ctype}\r\n"
                "Connection: close\r\n")
        if length is not None:
            head += f"Content-Length: {length}\r\n"
        return (head + extra + "\r\n").encode()

    def _write_json(self, writer, status: int, obj,
                    extra: str = "") -> None:
        payload = json.dumps(obj).encode()
        writer.write(self._head(status, length=len(payload), extra=extra)
                     + payload)

    def _error(self, writer, status: int, message: str,
               retry_after_s: float = 0.0) -> None:
        extra = (f"Retry-After: {max(1, int(np.ceil(retry_after_s)))}\r\n"
                 if status in (429, 503) else "")
        self._write_json(writer, status,
                         {"error": {"message": message,
                                    "type": _REASONS.get(status, ""),
                                    "code": status}}, extra=extra)

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode("latin-1").split(None, 2)
        except ValueError:
            return None
        headers = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            if b":" in hline:
                k, v = hline.decode("latin-1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0) or 0)
        if length > self.config.max_body_bytes:
            return method, path, headers, None
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _handle(self, reader, writer) -> None:
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            method, path, headers, body = parsed
            path, _, query = path.partition("?")
            if body is None:
                self._error(writer, 413, "request body too large")
            elif method == "GET" and path == "/healthz":
                alive = self._thread is not None and self._thread.is_alive()
                self._write_json(writer, 200 if alive else 503,
                                 {"status": "ok" if alive else "degraded",
                                  "step_thread_alive": alive})
            elif method == "GET" and path == "/statsz":
                self._write_json(writer, 200, self.stats())
            elif method == "GET" and path == "/metricsz":
                payload = self.metrics.render().encode()
                writer.write(self._head(
                    200, ctype="text/plain; version=0.0.4",
                    length=len(payload)) + payload)
            elif method == "GET" and path == "/tracez":
                doc = self.tracer.export()
                if "clear=1" in query.split("&"):
                    self.tracer.clear()
                self._write_json(writer, 200, doc)
            elif method == "GET" and path == "/v1/models":
                self._write_json(writer, 200, {
                    "object": "list",
                    "data": [{"id": self.config.model_id,
                              "object": "model", "owned_by": "repro"}]})
            elif method == "POST" and path == "/v1/completions":
                await self._handle_completion(reader, writer, headers,
                                              body)
            else:
                self._error(writer, 404, f"no route {method} {path}")
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception as e:                       # defensive: never 5xx
            try:                                     # with a dead socket
                self._error(writer, 500, f"{type(e).__name__}: {e}")
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        finally:
            try:
                writer.close()
            except RuntimeError:
                pass

    async def _handle_completion(self, reader, writer, headers,
                                 body: bytes) -> None:
        try:
            payload = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._error(writer, 400, "request body is not valid JSON")
            return
        tenant = (headers.get("x-tenant") or payload.get("user")
                  or "default")
        req, msg = self._make_request(payload, str(tenant))
        if req is None:
            self._error(writer, 400, msg)
            return
        verdict = self._offer(req)
        if not verdict.admitted:
            self._error(writer, verdict.status, verdict.reason,
                        retry_after_s=verdict.retry_after_s)
            return
        stream = self._streams[req.request_id]
        if payload.get("stream", False):
            await self._stream_sse(reader, writer, stream)
        else:
            await self._respond_blocking(reader, writer, stream)

    def _chunk(self, stream: _Stream, text: str,
               finish_reason: Optional[str] = None,
               ralm: Optional[dict] = None) -> dict:
        choice = {"index": 0, "text": text, "finish_reason": finish_reason}
        out = {"id": f"cmpl-{stream.rid}", "object": "text_completion",
               "model": self.config.model_id, "choices": [choice]}
        if ralm is not None:
            out["ralm"] = ralm
        return out

    def _ralm_ext(self, stream: _Stream, summary: dict) -> dict:
        return dict(tenant=stream.tenant,
                    degrade_levels=summary["degrade_levels"],
                    ttft_ms=summary["ttft_ms"],
                    tpot_ms=summary["tpot_ms"],
                    queue_wait_ms=summary["queue_wait_ms"])

    def _disconnect(self, stream: _Stream) -> None:
        with self._lock:
            gone = self._streams.pop(stream.rid, None)
        if gone is not None:
            self.disconnects += 1
        self._cancels.append(stream.rid)
        self._work.set()

    async def _stream_sse(self, reader, writer, stream: _Stream) -> None:
        writer.write(self._head(200, ctype="text/event-stream",
                                extra="Cache-Control: no-cache\r\n"))
        await writer.drain()
        conn_watch = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                getter = asyncio.ensure_future(stream.queue.get())
                done, _ = await asyncio.wait(
                    {getter, conn_watch},
                    return_when=asyncio.FIRST_COMPLETED)
                if conn_watch in done:
                    data = conn_watch.result()
                    if data:                  # stray bytes: keep watching
                        conn_watch = asyncio.ensure_future(reader.read(1))
                        if getter not in done:
                            continue
                    else:                     # EOF: client went away
                        getter.cancel()
                        self._disconnect(stream)
                        return
                kind, *rest = getter.result()
                if kind == "tok":
                    _, tok = rest
                    writer.write(self._sse(self._chunk(stream, f" {tok}")))
                    try:
                        await writer.drain()
                    except ConnectionError:
                        self._disconnect(stream)
                        return
                else:                         # ("done", summary)
                    summary = rest[0]
                    reason = ("cancelled" if summary["cancelled"]
                              else "length")
                    writer.write(self._sse(self._chunk(
                        stream, "", finish_reason=reason,
                        ralm=self._ralm_ext(stream, summary))))
                    writer.write(b"data: [DONE]\n\n")
                    await writer.drain()
                    return
        finally:
            conn_watch.cancel()

    @staticmethod
    def _sse(obj: dict) -> bytes:
        return f"data: {json.dumps(obj)}\n\n".encode()

    async def _respond_blocking(self, reader, writer,
                                stream: _Stream) -> None:
        tokens: List[int] = []
        while True:
            kind, *rest = await stream.queue.get()
            if kind == "tok":
                tokens.append(rest[1])
                continue
            summary = rest[0]
            text = "".join(f" {t}" for t in tokens)
            out = self._chunk(
                stream, text,
                finish_reason=("cancelled" if summary["cancelled"]
                               else "length"),
                ralm=self._ralm_ext(stream, summary))
            out["usage"] = {
                "prompt_tokens": stream.prompt_tokens,
                "completion_tokens": len(tokens),
                "total_tokens": stream.prompt_tokens + len(tokens)}
            self._write_json(writer, 200, out)
            return

    # ------------------------------------------------------------------
    # stats + lifecycle
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        eng = self.engine
        out = dict(
            uptime_s=time.perf_counter() - self._t_start,
            completions=self.completions,
            cancelled=self.cancelled,
            disconnects=self.disconnects,
            tokens_out=self.tokens_out,
            scheduler=self.scheduler.queue_stats(),
        )
        with self._lock:
            out["admission"] = self.admission.stats()
        if self.policy is not None:
            out["degrade"] = self.policy.stats()
        if eng.pool is not None:
            ps = eng.pool.stats
            out["kv_pool"] = dict(capacity=eng.pool.capacity,
                                  used=eng.pool.num_used,
                                  high_water=ps.high_water,
                                  waves=ps.waves,
                                  decode_compiles=ps.decode_compiles,
                                  skip_fraction=ps.skip_fraction(),
                                  blocks_total=ps.blocks_total,
                                  blocks_skipped=ps.blocks_skipped)
        # the port never falls back: what it can show is how often each
        # CUDA kernel launched (all 0 on the CPU)
        launches = {name: kern.launches
                    for name, kern in _build.kernels().items()}
        out["kernels"] = dict(launches=launches,
                              launch_total=sum(launches.values()))
        service = getattr(eng.retriever, "service", None)
        if service is not None:
            out["retrieval"] = service.stats.snapshot()
            replicas = getattr(service, "replicas", None)
            if replicas is not None:
                out["retrieval"]["fault"]["replicas"] = replicas.snapshot()
        straggler = getattr(self.scheduler, "straggler_events", None)
        if straggler is not None:
            out["scheduler"]["straggler_waves"] = straggler
        out["metrics"] = self.metrics.snapshot()
        return out

    async def start(self) -> str:
        """Bind + start serving on the running event loop; returns the
        base URL. Also starts the step-loop thread."""
        self._loop = asyncio.get_event_loop()
        self._server = await asyncio.start_server(
            self._handle, self.config.host, self.config.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._thread = threading.Thread(target=self._step_loop,
                                        name="gateway-step-loop",
                                        daemon=True)
        self._thread.start()
        return f"http://{self.config.host}:{self.port}"

    def start_background(self, timeout_s: float = 10.0) -> str:
        """Run the event loop on a dedicated thread (tests, benches,
        embedding the gateway next to other work). Returns the base
        URL once the socket is bound."""
        ready = threading.Event()
        url: List[str] = []

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)

            async def main():
                url.append(await self.start())
                ready.set()
                async with self._server:
                    try:
                        await self._server.serve_forever()
                    except asyncio.CancelledError:
                        pass

            try:
                loop.run_until_complete(main())
            finally:
                loop.close()

        self._loop_thread = threading.Thread(target=run,
                                             name="gateway-http",
                                             daemon=True)
        self._loop_thread.start()
        if not ready.wait(timeout_s):
            raise RuntimeError("gateway failed to bind within "
                               f"{timeout_s}s")
        return url[0]

    def serve_forever(self) -> None:
        """Blocking entry point for launchers."""

        async def main():
            base = await self.start()
            print(f"[gateway] serving {self.config.model_id} at {base} "
                  f"(POST {base}/v1/completions)")
            async with self._server:
                await self._server.serve_forever()

        try:
            asyncio.run(main())
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        loop, server = self._loop, self._server
        if loop is not None and server is not None and loop.is_running():
            loop.call_soon_threadsafe(server.close)
        thread = getattr(self, "_loop_thread", None)
        if thread is not None and loop is not None:
            # stop serve_forever() so the loop thread can exit
            for task in [t for t in (asyncio.all_tasks(loop)
                                     if loop.is_running() else [])]:
                loop.call_soon_threadsafe(task.cancel)
            thread.join(timeout=10.0)
