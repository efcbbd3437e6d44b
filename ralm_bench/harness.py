"""One run of one cell: set-up, warm-up, the measured window, the
per-layer readings (``--trace 1``), the correctness comparison, and the
result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the model's widths, the index's shape, the
engine's settings, its ``reference`` family module and its retrieval
mode, whose ``compare/<mode>.py`` judges it), a traffic mix
(``traffic/<mix>.json``, made by the generator its ``kind`` names) and
its limits (``limits/<cell>.json``). The per-layer metrics are
``metrics/<name>.py`` readers. Everything is found by the names in
``BENCHMARK.json``: nothing here names a cell, a configuration, a mix or
a metric.

The port is driven in-process through its serving entry:
``RalmEngine.from_config`` over a ``Datastore`` of the benchmark's index,
under the engine's ``RalmScheduler`` (``submit``, ``step``); every
request streams (``on_token``), so a token's time is when it reached the
host.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ralm_bench import check, inputs, peaks, profile, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 6.0       # the profiled tail of a --trace 1 window


class RunError(RuntimeError):
    """A run that must print no result."""


# -- the cell -----------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e


def load_cell(root: pathlib.Path, workload: str) -> Cell:
    """The cell's entries, from the checkout at ``root``: its
    ``BENCHMARK.json`` and, under ``ralm_bench/``, the mix
    (``traffic/<mix>.json``) and the limits (``limits/<cell>.json``)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = traffic.load(w["traffic"], root)
    limits = json.loads((root / "ralm_bench" / "limits" /
                         f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m
           or workload in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, w["chips"], config, mix, limits, e2e, per_layer)


def metric(name: str):
    """The reader module of the per-layer metric ``name``."""
    return importlib.import_module(f"ralm_bench.metrics.{name}")


# -- the system under test -------------------------------------------------


def model_config(model: dict):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**model)


def build_engine(cfg: dict, params, index: inputs.Index, max_seq: int,
                 kv_slots: int, device):
    """The port's monolithic wave engine over the benchmark's index."""
    from repro_torch.core.chamvs import ChamVSConfig
    from repro_torch.core.ivfpq import IVFPQConfig, IVFPQParams, IVFPQShard
    from repro_torch.core.rag import RagConfig
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.datastore import Datastore
    from repro_torch.serve.engine import RalmEngine

    icfg = cfg["index"]
    ivf = IVFPQConfig(dim=cfg["model"]["d_model"], nlist=icfg["nlist"],
                      m=icfg["m"], nbits=icfg["nbits"],
                      residual=icfg["residual"],
                      list_cap=index.codes.shape[2])
    ds = Datastore(params=IVFPQParams(index.centroids, index.codebooks),
                   shards=[IVFPQShard(index.codes[s], index.ids[s],
                                      index.lens[s])
                           for s in range(index.codes.shape[0])],
                   index_cfg=ivf, payload_tokens=index.payload,
                   num_vectors=index.num_vectors)
    search = ChamVSConfig(ivfpq=ivf, nprobe=icfg["nprobe"],
                          k=cfg["rag"]["k"], eps=icfg["eps"],
                          fused=icfg["fused"])
    ecfg = EngineConfig(model=model_config(cfg["model"]),
                        rag=RagConfig(**cfg["rag"]), max_seq=max_seq,
                        kv_slots=kv_slots, **cfg["engine"])
    return RalmEngine.from_config(ecfg, params, ds, search, device=device)


def _record_neighbours(eng, live: Dict[int, traffic.Request]) -> None:
    """Every run: the neighbours (distances and ids) that the wave engine
    mixes for a traced request's rows, copied on the device as its
    ``finish_wave`` takes them from the search, so that recording adds no
    wait for the device to the timed path (the engine's own request trace
    copies the ids to the host)."""
    finish = eng.finish_wave

    def finish_wave(seqs, decoded, searches):
        for seq, search in zip(seqs, searches):
            req = live.get(seq.request.request_id)
            if req is not None and req.traced and search is not None:
                d, i = search.result()
                req.neighbours.append((seq.step, d.clone(), i.clone()))
        return finish(seqs, decoded, searches)

    eng.finish_wave = finish_wave


# -- instrumentation of the traced run ---------------------------------------


class Instrument:
    """``--trace 1`` only: host clocks around the scheduler's step and the
    engine's admissions, ``bench.<label>`` ranges around the engine's
    calls for the profiler, and, while the profiler records device time,
    the calls that the cell's metric readers probe (``PROBE``, ``record``:
    ``metrics/__init__.py``)."""

    def __init__(self, eng, metrics: List[str]):
        import repro_torch.core.rag as rag_mod
        self.eng = eng
        self.rag_mod = rag_mod
        self.saved = []
        self.ranges = False          # bench.<label> ranges (labelled half)
        self.shapes = False          # probed calls (CUDA-only half)
        self.admit_s: List[float] = []
        self.waves = 0
        self.probes: Dict[str, list] = {}    # "<module>:<fn>" -> readers
        for name in metrics:
            mod = metric(name)
            if hasattr(mod, "PROBE"):
                self.probes.setdefault(mod.PROBE, []).append(
                    (name, mod.record))
        self.records: Dict[str, list] = {
            name: [] for readers in self.probes.values()
            for name, _ in readers}

    def _patch(self, obj, attr, wrapper):
        orig = getattr(obj, attr)
        self.saved.append((obj, attr, orig, attr in vars(obj)))
        setattr(obj, attr, wrapper(orig))

    def _ranged(self, label):
        def wrap(fn):
            def call(*a, **kw):
                if not self.ranges:
                    return fn(*a, **kw)
                with torch.profiler.record_function(profile.PREFIX + label):
                    return fn(*a, **kw)
            return call
        return wrap

    def install(self) -> None:
        eng = self.eng

        def admit(fn):
            ranged = self._ranged("admit")(fn)

            def call(*a, **kw):
                t0 = time.perf_counter()
                out = ranged(*a, **kw)
                self.admit_s.append(time.perf_counter() - t0)
                return out
            return call

        def wave(fn):
            ranged = self._ranged("decode")(fn)

            def call(seqs, *a, **kw):
                if any(s.step > 0 for s in seqs):
                    self.waves += 1
                return ranged(seqs, *a, **kw)
            return call

        def probed(readers):
            def wrap(fn):
                def call(*a, **kw):
                    if self.shapes:
                        for name, record in readers:
                            self.records[name].append(record(*a, **kw))
                    return fn(*a, **kw)
                return call
            return wrap

        self._patch(eng, "start", admit)
        self._patch(eng, "dispatch_wave", wave)
        self._patch(eng, "dispatch_search_wave", self._ranged("search"))
        self._patch(eng, "flush_searches", self._ranged("search"))
        self._patch(eng, "finish_wave", self._ranged("finish"))
        self._patch(eng.retriever, "resolve", self._ranged("resolve"))
        self._patch(self.rag_mod, "knnlm_interpolate", self._ranged("mix"))
        for target, readers in self.probes.items():
            module, fn = target.split(":")
            self._patch(importlib.import_module(module), fn,
                        probed(readers))

    def uninstall(self) -> None:
        for obj, attr, orig, own in reversed(self.saved):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self.saved.clear()


# -- the run ----------------------------------------------------------------


class TracedTail:
    """``--trace 1``: ``TRACE_SECONDS`` from the last ``TRACE_SECONDS`` of
    the window on, profiled in two halves of equal length (``profile``):
    CUDA activity alone (busy time, kernel times, and the probed calls
    the rooflines need), then CPU and CUDA activity with the harness's
    ranges (device time by engine call, idle gaps by what the host was
    doing). Stopping the first profiler takes seconds, so the second half
    may run past the window's end: the loop goes on until it is done. The
    host-clock readers take the window before the profiler starts."""

    def __init__(self, inst: Instrument, dev, t0: float, t1: float):
        self.inst, self.cuda, self.t0 = inst, dev.type == "cuda", t0
        self.ta = max(t0, t1 - TRACE_SECONDS)
        self.half = TRACE_SECONDS / 2
        self.phase = self.prof = self.win = self.host = None
        self.out: dict = {}
        inst.admit_s.clear()
        inst.waves = 0

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _mark(self, step_s: float) -> None:
        self.mark = (time.perf_counter(), self.inst.waves, step_s,
                     len(self.inst.admit_s))

    def _since_mark(self, step_s: float):
        """(host ms a wave, waves) since the last mark."""
        _, waves, s, n_admit = self.mark
        n = self.inst.waves - waves
        busy = step_s - s - sum(self.inst.admit_s[n_admit:])
        return 1e3 * busy / max(1, n), n

    def _host(self, now: float, step_s: float) -> dict:
        inst = self.inst
        return dict(window_s=now - self.t0, wave_s=step_s - sum(inst.admit_s),
                    waves=inst.waves, admit_s=list(inst.admit_s))

    def tick(self, now: float, step_s: float) -> None:
        if self.phase is None and now >= self.ta:
            self.host = self._host(now, step_s)
            self._sync()
            self.prof = profile.start(cpu=False) if self.cuda else None
            self._mark(step_s)
            self.inst.shapes = True
            self.phase = "device"
        elif self.phase == "device" and now - self.mark[0] >= self.half:
            self._close_device(step_s)
            self.prof = profile.start(cpu=True) if self.cuda else None
            self.win = torch.profiler.record_function(profile.PREFIX +
                                                      "window")
            self.win.__enter__()
            self._mark(step_s)
            self.inst.ranges = True
            self.phase = "labelled"

    def done(self, now: float) -> bool:
        return self.phase == "labelled" and now - self.mark[0] >= self.half

    def _close_device(self, step_s: float) -> None:
        self._sync()
        window_s = time.perf_counter() - self.mark[0]
        self.inst.shapes = False
        ms, n = self._since_mark(step_s)
        self.out.update(device_host_wave_ms=ms, device_waves=n)
        if self.prof is not None:
            self.out.update(profile.device_summary(self.prof, window_s))
            self.out["launches"] = self.inst.records

    def finish(self, t_end: float, step_s: float):
        """(the trace summary, or None without a card; the host part)."""
        if self.phase == "device":
            self._close_device(step_s)
        elif self.phase == "labelled":
            self.inst.ranges = False
            self.win.__exit__(None, None, None)
            self._sync()
            ms, n = self._since_mark(step_s)
            self.out.update(host_wave_ms=ms, waves=n)
            if self.prof is not None:
                self.out.update(profile.labelled_summary(self.prof))
        if self.host is None:
            self.host = self._host(t_end, step_s)
        self.host["t_end"] = self.t0 + self.host["window_s"]
        self.inst.uninstall()
        traced = self.cuda and "by_label" in self.out and \
            "by_kernel" in self.out
        return (self.out if traced else None), self.host


@dataclasses.dataclass
class Observation:
    """What the per-layer readers read."""
    model: dict
    lens: torch.Tensor
    peak: Optional[dict]
    host: Optional[dict] = None
    trace: Optional[dict] = None


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q,
                               method="linear"))


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _log(msg: str) -> None:
    print(f"[ralm_bench] {msg}", file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    """One run; ``control`` also reads the precision control on the same
    sample (``control.py``, never the benchmark's own runs)."""
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise RunError(f"needs {cell.chips} CUDA device(s); found "
                           f"{torch.cuda.device_count()}")
        torch.cuda.set_device(0)
    # one host thread for the harness's and the engine's CPU ops: idle
    # worker threads spinning beside the thread that launches the kernels
    # slow it by amounts that differ from run to run
    torch.set_num_threads(1)
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    peak = peaks.peaks(kind)

    # inputs, made from the seed
    model = cfg["model"]
    family = check.family(cfg)
    params = family.make_weights(model, cfg["weights"], seed, dev)
    icfg = cfg["index"]
    keys = inputs.reference_keys(family, params, model,
                                 inputs.key_count(icfg),
                                 icfg["key_prefix_len"], seed, dev)
    index = inputs.build_index(icfg, keys, model["vocab_size"], seed)
    del keys
    gen = traffic.generator(mix).Traffic(mix, seed, model["vocab_size"],
                                         dev)
    eng = build_engine(cfg, params, index, gen.max_seq, gen.slots, dev)
    sched = eng.scheduler
    done: List[traffic.Request] = []
    live: Dict[int, traffic.Request] = {}
    _record_neighbours(eng, live)
    inst = Instrument(eng, [m["name"] for m in cell.per_layer]) \
        if trace else None
    if inst is not None:
        inst.install()
    steps = 0

    def submit(req: traffic.Request) -> None:
        from repro_torch.serve.api import RalmRequest

        def on_token(step, toks, req=req):
            req.times.append(time.perf_counter())
            if req.traced:
                req.tokens.append(toks)

        req.t_submit = time.perf_counter()
        rid = sched.submit(RalmRequest(prompt=req.prompt, steps=req.steps,
                                       greedy=True, on_token=on_token))
        live[rid] = req

    def step() -> None:
        nonlocal steps
        steps += 1
        for req in gen.due(time.perf_counter(), steps):
            submit(req)
        for resp in sched.step():
            req = live.pop(resp.request_id)
            req.partial = resp.partial_steps
            if not req.traced:
                req.prompt = None
            done.append(req)
            for nxt in gen.after(req):
                submit(nxt)

    # warm-up: the traffic's own (a closed loop runs until every client
    # has finished a request)
    while not gen.warmed:
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_warm = len(done)

    # the measured window
    t0 = time.perf_counter()
    t1 = t0 + seconds
    tail = TracedTail(inst, dev, t0, t1) if inst is not None else None
    step_s = 0.0
    while True:
        now = time.perf_counter()
        if now >= t1 and (tail is None or tail.done(now)):
            break
        if tail is not None:
            tail.tick(now, step_s)
        s0 = time.perf_counter()
        step()
        step_s += time.perf_counter() - s0
    t_end = time.perf_counter()
    trace_summary = host = None
    if tail is not None:
        trace_summary, host = tail.finish(t_end, step_s)
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

    # what the window served
    offered = done + list(live.values())
    in_window = [r for r in offered if any(t0 <= t < t1 for t in r.times)]
    tokens, gaps, ttft = 0, [], []
    parts = [0] * 6           # tokens by sixth of the window (diagnosis)
    for r in offered:
        ts = r.times
        for i, t in enumerate(ts):
            if t0 <= t < t1:
                tokens += r.rows
                parts[min(5, int(6 * (t - t0) / seconds))] += r.rows
                if i > 0:
                    gaps.extend([t - ts[i - 1]] * r.rows)
        if ts and t0 <= ts[0] < t1:
            ttft.append(ts[0] - r.t_submit)
    finished = [r for r in done[n_warm:] if t0 <= r.times[-1] < t1]
    attempted = sum(1 for r in offered if r.t_submit < t1 and not (
        len(r.times) == r.steps and r.times[-1] < t0))
    failed = sum(1 for r in finished if r.partial)
    e2e = {
        "tokens_per_s": (tokens / seconds, "tokens/s"),
        "token_gap_p95_ms": (None if not gaps else
                             1e3 * _percentile(gaps, 95), "ms"),
        "ttft_p90_ms": (None if not ttft else
                        1e3 * _percentile(ttft, 90), "ms"),
        "setup_s": (t0 - t_start, "s"),
    }
    resident = dict(weights=_bytes(params), **index.resident_bytes())
    service = getattr(eng.retriever, "service", None)
    stacked = getattr(getattr(service, "pipeline", None), "stacked", None)
    if stacked is not None:
        resident["stacked_codes"] = _bytes(stacked.codes)
        resident["stacked_ids"] = _bytes(stacked.ids)
    if eng.pool is not None:
        resident["kv_pool"] = _bytes(eng.pool.caches)

    if host is not None:
        # counts for the host-clock readers over the same part
        h_end = host["t_end"]
        host["prefills"] = [(r.rows, r.prompt_len) for r in offered
                            if r.times and t0 <= r.times[0] < h_end]
        host["decodes"] = [(r.rows, r.prompt_len + i - 1) for r in offered
                           for i, t in enumerate(r.times)
                           if i > 0 and t0 <= t < h_end]

    # free the program's state before the reference runs
    del eng, sched, inst, tail, service, stacked, offered
    live.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    result = dict(attempted=attempted, failed=failed, mem_peak=mem_peak,
                  kind=kind, e2e=e2e, resident=resident, finished=finished,
                  in_window=len(in_window), tokens=tokens,
                  n_ttft=len(ttft), n_gaps=len(gaps), parts=parts)
    result["checks"] = check.judge_run(cfg, mix, cell.limits, params, index,
                                       finished, seed, control)
    if trace:
        obs = Observation(model=model, lens=index.lens.cpu(), peak=peak,
                          host=host, trace=trace_summary)
        readers = {m["name"]: metric(m["name"]) for m in cell.per_layer}
        result["per_layer"] = {m["name"]: (readers[m["name"]].read(obs),
                                           m["unit"])
                               for m in cell.per_layer}
        described = {name: mod.describe(obs) for name, mod in readers.items()
                     if hasattr(mod, "describe")}
        result["described"] = {k: v for k, v in described.items()
                               if v is not None}
        result["trace"] = trace_summary
        result["host"] = host
    return result


def forbidden_modules() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def main(argv: Optional[List[str]], t_start: float, root: pathlib.Path,
         device: str = "cuda") -> int:
    """The command line of ``run.py`` over the checkout at ``root``
    (``device`` "cpu": the port's plain versions, for the tests)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        importlib.import_module("repro_torch.serve.engine")
    except ImportError as e:
        _log(f"error: the port under test does not import: {e}")
        return 2
    try:
        cell = load_cell(root, args.workload)
        res = run(cell, args.seed, args.seconds, bool(args.trace), device,
                  t_start)
    except RunError as e:
        _log(f"error: {e}")
        return 2
    bad = forbidden_modules()
    if bad:
        _log(f"error: modules loaded that the port must not use: {bad}")
        return 3
    return report(cell, res, bool(args.trace), device)


def report(cell: Cell, res: dict, trace: bool, device: str) -> int:
    mb = {k: round(v / 2 ** 20, 1) for k, v in res["resident"].items()}
    first = dict(resident_mb=mb,
                 max_memory_allocated_mb=round(res["mem_peak"] / 2 ** 20, 1),
                 requests_in_window=res["in_window"],
                 finished_in_window=len(res["finished"]),
                 ttft_samples=res["n_ttft"], gap_samples=res["n_gaps"],
                 tokens_by_sixth=res["parts"],
                 end_to_end={n: v for n, (v, _) in res["e2e"].items()})
    first.update(res.get("described", {}))
    if trace and res.get("host"):
        first["host_part_s"] = res["host"]["window_s"]
    if res.get("trace"):
        first["device_s_by_label"] = res["trace"]["by_label"]
        tr = res["trace"]
        first["profiled"] = dict(
            device_half=dict(waves=tr["device_waves"],
                             host_wave_ms=tr["device_host_wave_ms"],
                             busy_s=tr["busy_s"], window_s=tr["window_s"]),
            labelled_half=dict(waves=tr["waves"],
                               host_wave_ms=tr["host_wave_ms"],
                               busy_s=tr["labelled_busy_s"],
                               window_s=tr["labelled_window_s"]))
    print("[ralm_bench] " + json.dumps(first), flush=True)
    checks = res["checks"]
    if trace:
        metrics = {n: {"value": v, "unit": u}
                   for n, (v, u) in res["per_layer"].items() if v is not None}
    else:
        names = [m["name"] for m in cell.end_to_end]
        metrics = {n: {"value": v, "unit": u}
                   for n, (v, u) in res["e2e"].items()
                   if n in names and v is not None}
    out = dict(correct=checks["correct"], attempted=res["attempted"],
               failed=res["failed"], metrics=metrics,
               device=dict(platform="gpu" if device == "cuda" else device,
                           kind=res["kind"], count=cell.chips,
                           memory_peak_bytes=int(res["mem_peak"])))
    tr = res.get("trace")
    if trace and tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = profile.breakdown(tr)
    out["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                     for n, c in checks["numbers"].items()}
    for n, c in checks["numbers"].items():
        _log(f"check {n} = {c['value']!r} limit {c['limit']!r} "
             f"({c['what']})")
    _log(f"correct = {checks['correct']} ({checks['why']})")
    print(json.dumps(out), flush=True)
    return 0
