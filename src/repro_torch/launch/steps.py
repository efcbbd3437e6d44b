"""Step builders (twin of ``repro.launch.steps``): the training step,
and the dry run's prefill and serve steps.

``build_train_step`` returns ``train_step(params, opt_state, batch)``:
forward, backward through ``transformer.lm_loss`` (the FA2 attention
backward, ``remat`` per layer cycle), gradient accumulation over
micro-batches, and AdamW, updating the parameter and moment tensors in
place. The reference's step is one jitted, GSPMD-sharded program over
the global batch; here it runs eagerly on each rank, and the
parallelism is explicit. With a ``group`` (``launch.dp.Group``) of more
than one rank and a model axis of 1, every rank holds every parameter
and the step all-reduces the summed loss, the valid-token count and
every gradient, so the mean is the global batch's mean even where
labels are masked. With a model axis of more than 1 the step is sharded
(``_sharded_train_step``): each rank holds the shard of every parameter
and moment that the reference's ``sanitize(param_specs(...))`` gives
its mesh position (``TrainLayout``), the layers gather each leaf over
"data" as they run (a MoE's experts stay on their owners: expert
parallelism) and split their matmuls over "model"
(``models.transformer``), gradients come back reduce-scattered into the
shards, and AdamW updates the shards. In both, each rank holds its rows
of the global batch, and the step's context names the data group, so
a MoE routes the global (micro-)batch as the reference's program does;
micro-batch i is the reference's, the global rows [i B/m, (i+1) B/m),
of which each data rank computes its 1/D (``_split``).

``build_prefill_step`` (the full-sequence forward that fills the KV
cache) and ``build_serve_step`` (one retrieval-augmented decode step,
the paper's Fig. 3) take the reference's ``(spec, shape_name, mesh)``
and return the step with the reference's partition specs (sanitised as
the reference sanitises them) and abstract inputs (``launch.specs``).
Where the reference jits a GSPMD program over the mesh, these steps are
plain eager functions that run on whatever device their tensors are on:
CUDA tensors launch the port's kernels, CPU tensors run the plain
versions, and meta tensors (the dry run) only propagate shapes.

Without a rank group (or with a group of one) a step runs in one
process on whole tensors, its specs descriptive. With the ``group`` of a
``data x model`` mesh of ranks (``launch.dp``), whose mesh the specs are
computed over, each rank runs the step on its own shards: the ones
``put_named`` gives it from the returned specs (parameters, caches,
batch, and the serve step's DB params and shards, payload and ``proj``).
It returns its shards under the reference's out specs: the logits
``P(dp, "model")`` (sanitised: this rank's rows and vocabulary columns)
and the caches; ``gather_named`` reassembles them. The layers read each
parameter through ``models.parallel.leaf`` (gathered over "data",
computed split over "model" where ``TP_GROUPS`` allows), the K/V caches
hold a range of the slots, a linear cache's or a local layer's ring's
(over "model" at a batch of 8 or more, whose rows split over the data
axes; over data x model below that, every rank holding every row), and
decode attention merges the ranks' partial softmaxes. The Mamba and
RWKV-6 state splits its heads or channels over "model" and its rows as
the K/V's; a layer computed split over "model" keeps it there, one
computed replicated (Hymba's 25 heads over 2 ranks) gathers it whole
over "model" and keeps its own part. The MoE FFN routes the global
batch, its input rows all-gathered over the data axes where they are
split (the reference's capacity counts every token of the batch), each
data rank running its own experts. The serve step's search is
``retrieval.router``'s mesh search (one DB shard per data rank), its
payload gather sums the ranks' slices of the table, and the kNN-LM mix
runs on the vocabulary columns of the rank. Each step's collectives add their bytes and host
milliseconds to the group's ``stats`` (``step.stats()`` after a step:
``data_mb`` / ``data_ms``, ``model_mb`` / ``model_ms``, ``mesh_mb`` /
``mesh_ms`` for those over the whole mesh). Every block family is
served: dense, hybrid (Hymba), RWKV-6 and MoE decoders, with linear and
ring caches, and dense encoder-decoders.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import SHAPES, ArchSpec
from repro_torch.core import rag as rag_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.ctx import activation_sharding
from repro_torch.models import parallel
from repro_torch.models.sharding import (P, cache_specs, dp_axes,
                                         gather_named, keyed_specs,
                                         param_specs, put_named, sanitize,
                                         shard_shape)
from repro_torch.optim import adamw
from repro_torch.retrieval import router as router_lib
from repro_torch.retrieval.service import search_stacked


def abstract_params(cfg: ModelConfig):
    """``init_params``'s tree on the meta device: shapes and dtypes,
    nothing drawn or allocated (the reference's ``jax.eval_shape``)."""
    return tf.init_params(None, cfg)


def default_microbatches(spec: ArchSpec, shape_name: str,
                         world_size: int) -> int:
    """Gradient-accumulation factor so that each micro-batch's saved
    activations (n_layers x [B_loc, T, d] bf16 under remat) stay within
    6 GB beside the parameters, moments and gradients."""
    cfg = spec.model
    sh = SHAPES[shape_name]
    b_loc = max(sh["global_batch"] // max(world_size, 1), 1)
    save_bytes = cfg.n_layers * b_loc * sh["seq_len"] * cfg.d_model * 2
    budget = 6e9
    micro = 1
    while save_bytes / micro > budget and micro < b_loc:
        micro *= 2
    return micro


def _rows_dim(key: str, v: torch.Tensor) -> int:
    """A batch tensor's rows dim ([3, B, T] positions: 1)."""
    return 1 if key == "positions" and v.ndim == 3 else 0


def _split(batch: Dict[str, torch.Tensor], n: int, rows=None):
    """``n`` micro-batches, the i-th the rows [i B/n, (i+1) B/n) of the
    global batch. ``rows``: the data axes' group where each rank holds
    its B/D consecutive rows of it: at n > 1 the batch is all-gathered
    over it first and each rank keeps its 1/D of every micro-batch."""
    D = 1 if rows is None else rows.size
    if n > 1 and D > 1:
        batch = {k: rows.all_gather(v.contiguous(), _rows_dim(k, v))
                 for k, v in batch.items()}
    parts = []
    for i in range(n):
        mb = {}
        for k, v in batch.items():
            v = torch.chunk(v, n, dim=_rows_dim(k, v))[i]
            if n > 1 and D > 1:
                v = torch.chunk(v, D, dim=_rows_dim(k, v))[rows.rank]
            mb[k] = v
        parts.append(mb)
    return parts


def _counts(parts, group, dev) -> torch.Tensor:
    """Each micro-batch's valid labels over the global batch (summed over
    ``group``, the data ranks), at least 1: [n] float32."""
    n = torch.stack([(mb["labels"] >= 0).sum() for mb in parts])
    n = n.float().to(dev)
    return (n if group is None else group.all_reduce(n)).clamp(min=1)


def _grad(loss: torch.Tensor, leaves):
    """d loss / d leaves; zeros for a leaf the loss does not read (the
    token table under a batch of ``embeds``), as JAX gives."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class TrainLayout:
    """Where a sharded step's state lives: ``specs``, the sanitised
    parameter specs over the rank group's mesh, and ``state_specs`` for
    (params, opt_state). ``put`` keeps this rank's shards of whole
    trees, ``gather`` gives whole trees back (every rank must call it),
    ``check`` raises unless every leaf has its shard's shape."""

    def __init__(self, cfg: ModelConfig, group):
        self.group, self.mesh = group, group.mesh
        struct = abstract_params(cfg)
        self.specs = sanitize(param_specs(cfg, self.mesh, struct), struct,
                              self.mesh)
        self.keyed = keyed_specs(self.specs)
        self.state_specs = (self.specs, adamw.OptState(
            step=P(), m=self.specs, v=self.specs))
        self.shapes = {k: shard_shape(t.shape, self.keyed[k], self.mesh)
                       for k, t in tree_lib.keyed(struct).items()}
        live = [a for a, n in group.shape.items() if n > 1]
        coords = group.coords
        #: per leaf: counted in the global norm on this rank (coordinate 0
        #: of every axis it is replicated over); replicated over "data"
        self.counted, self.over_data = [], []
        for spec in self.keyed.values():
            axes = {a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))}
            self.counted.append(all(coords[a] == 0 for a in live
                                    if a not in axes))
            self.over_data.append("data" not in axes)

    def put(self, tree):
        return put_named(tree, self.state_specs, self.mesh, self.group)

    def gather(self, tree):
        return gather_named(tree, self.state_specs, self.mesh, self.group)

    def check(self, params, opt_state) -> None:
        for tree in (params, opt_state.m, opt_state.v):
            for key, leaf in tree_lib.keyed(tree).items():
                if tuple(leaf.shape) != self.shapes[key]:
                    raise ValueError(
                        f"{key}: local shape {tuple(leaf.shape)} is not the "
                        f"shard {self.shapes[key]} of {self.keyed[key]} "
                        f"over {self.mesh.shape}")


def build_train_step(cfg: ModelConfig,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     remat: bool = True, microbatches: int = 1,
                     group=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``. Metrics: ``loss``, ``grad_norm``, ``lr``;
    with a data-parallel group of more than one rank ``allreduce_ms`` /
    ``allreduce_bytes`` (the staged all-reduce, host wall time); sharded
    (a group with a model axis of more than 1), ``data_mb`` /
    ``data_ms`` / ``model_mb`` / ``model_ms``, each axis's collectives in
    the step (bytes and host wall time). ``train_step.layout`` is the
    sharded step's ``TrainLayout`` (None otherwise): its state must be
    put in place before the first step.

    One rank follows the reference: the loss is the mean of the
    micro-batches' means, the gradients their mean, accumulated in
    float32 (micro-batches of 1: the parameters' dtype)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if group is not None and group.shape["model"] > 1:
        return _sharded_train_step(cfg, opt_cfg, remat, microbatches, group)
    dp = group is not None and group.size > 1

    def train_step(params, opt_state, batch):
        with activation_sharding(("data",), "model"):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        metrics = {}
        if dp:
            dev = leaves[0].device
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                   for p in leaves]
            total = torch.zeros((), dtype=torch.float32, device=dev)
            count = torch.zeros_like(total)
            parts = _split(batch, microbatches, group)
            # m > 1: the mean of the global micro-batches' means
            counts = _counts(parts, group, dev) if microbatches > 1 \
                else None
            for i, mb in enumerate(parts):
                rows = mb["labels"].shape[0]
                with activation_sharding(("data",), "model", group=group,
                                         batch=rows * group.size):
                    s, n = tf.nll_sum(params, cfg, mb, remat=remat)
                    if counts is not None:
                        s = s / counts[i]
                    for a, g in zip(acc, _grad(s, leaves)):
                        a += g.float()
                total += s.detach()
                count += n
            flat = torch.cat([total.reshape(1), count.reshape(1)]
                             + [a.reshape(-1) for a in acc])
            _sync(flat)
            t0 = time.perf_counter()
            group.all_reduce(flat, "sum")
            _sync(flat)
            metrics["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
            metrics["allreduce_bytes"] = flat.numel() * flat.element_size()
            denom = flat[1].clamp(min=1) if counts is None else microbatches
            loss = flat[0] / denom
            grads, off = [], 2
            for a in acc:
                grads.append((flat[off:off + a.numel()] / denom).view(a.shape))
                off += a.numel()
        elif microbatches <= 1:
            loss = tf.lm_loss(params, cfg, batch, remat=remat)
            grads = _grad(loss, leaves)
            loss = loss.detach()
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split(batch, microbatches):
                mloss = tf.lm_loss(params, cfg, mb, remat=remat)
                for a, g in zip(grads, _grad(mloss, leaves)):
                    a += g.float()
                loss = loss + mloss.detach()
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        grads = tree_lib.unflatten_like(params, iter(grads))
        params, opt_state, m = adamw.apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics.update(m, loss=loss)
        return params, opt_state, metrics

    train_step.layout = None
    return train_step


def _sharded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                        remat: bool, microbatches: int, group):
    """The step on this rank's shards (see the module docstring). The
    loss is the reference's, the mean over micro-batches of each global
    micro-batch's summed NLL over its global valid-token count: the
    counts are all-reduced over "data" first, each micro-batch's local
    sum over its count is differentiated (the data axis's
    reduce-scatters add the rows' shares), and the gradients of leaves
    replicated over "data" are all-reduced over it in one float32
    buffer beside the loss."""
    layout = TrainLayout(cfg, group)
    dp = dp_axes(layout.mesh)
    data, model = group.axis("data"), group.axis("model")
    D = group.shape["data"]

    def train_step(params, opt_state, batch):
        layout.check(params, opt_state)
        for g in (group, data, model):
            g.stats.update(bytes=0, ms=0.0)
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        dev = leaves[0].device
        parts = _split(batch, microbatches, data)
        counts = _counts(parts, data, dev) * microbatches
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in leaves]
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(parts):
            rows = mb["labels"].shape[0]
            with activation_sharding(dp, "model", group=group,
                                     specs=layout.keyed, batch=rows * D):
                s, _ = tf.nll_sum(params, cfg, mb, remat=remat)
                s = s / counts[i]
                for a, g in zip(acc, _grad(s, leaves)):
                    a += g.float()
            total += s.detach()
        if D > 1:
            rep = [a for a, r in zip(acc, layout.over_data) if r]
            flat = data.all_reduce(torch.cat(
                [total.reshape(1)] + [a.reshape(-1) for a in rep]))
            total, off = flat[0], 1
            for a in rep:
                a.copy_(flat[off:off + a.numel()].view(a.shape))
                off += a.numel()
        grads = tree_lib.unflatten_like(params, iter(acc))
        params, opt_state, m = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, group=group,
            counted=layout.counted)
        metrics = dict(m, loss=total)
        for name, g in (("data", data), ("model", model)):
            metrics[f"{name}_mb"] = g.stats["bytes"] / 1e6
            metrics[f"{name}_ms"] = g.stats["ms"]
        return params, opt_state, metrics

    train_step.layout = layout
    return train_step


# ---------------------------------------------------------------------------
# serving on a mesh of ranks
# ---------------------------------------------------------------------------

def _serving_group(mesh, group):
    """``group`` when it spans more than one rank (checked against
    ``mesh``), else None."""
    if group is None or group.size == 1:
        return None
    if dict(mesh.shape) != dict(group.shape):
        raise ValueError(f"mesh {dict(mesh.shape)} is not the rank group's "
                         f"{group.shape}")
    return group


class _Stats:
    """The step's collective bytes and host milliseconds over each axis
    of ``group`` and over the whole mesh (reset at the step's start); an
    axis that spans the whole mesh owns its collectives, and "mesh" then
    counts none."""

    def __init__(self, group):
        self.groups = {"data": group.axis("data"),
                       "model": group.axis("model"), "mesh": group}

    def reset(self) -> None:
        for g in self.groups.values():
            g.stats.update(bytes=0, ms=0.0)

    def __call__(self) -> Dict[str, float]:
        out, seen = {}, set()
        for name, g in self.groups.items():
            if id(g) in seen:       # the mesh, when an axis spans it
                out[f"{name}_mb"], out[f"{name}_ms"] = 0.0, 0.0
                continue
            seen.add(id(g))
            out[f"{name}_mb"] = g.stats["bytes"] / 1e6
            out[f"{name}_ms"] = g.stats["ms"]
        return out


def _sharded_context(group, dp, kv_batch, kv_seq, p_specs, c_specs,
                     batch: Optional[int]):
    """A step's ``activation_sharding`` over ``group``, every time the
    step runs."""
    keyed = dict(specs=keyed_specs(p_specs), caches=keyed_specs(c_specs))
    return lambda: activation_sharding(
        dp, "model", kv_batch=kv_batch, kv_seq=kv_seq, group=group,
        batch=batch, **keyed)


def _axes(spec, dim: int = 0) -> tuple:
    """The axes a spec splits dimension ``dim`` over (() when whole)."""
    entries = tuple(spec)
    entry = entries[dim] if dim < len(entries) else None
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _cache_rows(c_specs) -> tuple:
    """The axes the caches split their batch rows over: the K/V's, or
    RWKV-6's state's (it has no K/V)."""
    keyed = keyed_specs(c_specs)
    return next((_axes(v, 1) for k, v in keyed.items()
                 if k.endswith(("/k", "/wkv"))), ())


# ---------------------------------------------------------------------------
# serving: prefill
# ---------------------------------------------------------------------------

def build_prefill_step(spec: ArchSpec, shape_name: str, mesh, group=None):
    """Returns ``(prefill_step, (param_specs, cache_specs, batch_specs))``.

    ``prefill_step(params, caches, batch) -> (last-position logits
    [B, V], caches)``: an encoder-decoder's ``enc_embeds`` go through
    ``encode`` first; the caches are filled in place. With a ``group`` of
    more than one rank: the rank's shards in, its shards out (the module
    docstring); where the batch's rows split over the data axes but the
    caches' do not (a batch below 8 that the data axes divide), the rows
    are all-gathered first and the logits' rows cut after."""
    cfg = spec.model
    sh = SHAPES[shape_name]
    dp = dp_axes(mesh)
    group = _serving_group(mesh, group)

    kv_batch = "dp" if sh["global_batch"] >= 8 else None
    kv_seq = "model" if sh["global_batch"] >= 8 else ("dp", "model")

    p_struct = abstract_params(cfg)
    p_specs = sanitize(param_specs(cfg, mesh, p_struct), p_struct, mesh)
    c_struct = specs_lib.cache_struct(spec, shape_name)
    c_specs = sanitize(
        cache_specs(cfg, mesh, c_struct, shard_seq=(sh["global_batch"] < 8)),
        c_struct, mesh)
    b_struct = specs_lib.prefill_struct(spec, shape_name)
    b_specs = {k: P(dp, *([None] * (v.dim() - 1)))
               if k != "positions" or v.shape[0] != 3
               else P(None, dp, None)
               for k, v in b_struct.items()}
    b_specs = sanitize(b_specs, b_struct, mesh)

    def forward(params, caches, batch):
        enc_states = None
        if "enc_embeds" in batch:
            enc_states = tf.encode(params, cfg, batch["enc_embeds"])
        logits, caches = tf.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), positions=batch.get("positions"),
            mode="prefill", caches=caches, enc_states=enc_states)
        return logits[:, -1], caches

    if group is None:
        regather, stats = False, None

        def context():
            return activation_sharding(dp, "model", kv_batch=kv_batch,
                                       kv_seq=kv_seq)
    else:
        rows = _axes(b_specs["tokens" if "tokens" in b_specs else "embeds"])
        regather = bool(rows) and not _cache_rows(c_specs)
        row_group = group.over(rows)
        stats = _Stats(group)
        context = _sharded_context(group, dp, kv_batch, kv_seq, p_specs,
                                   c_specs, sh["global_batch"]
                                   if rows and not regather else None)

    @torch.no_grad()
    def prefill_step(params, caches, batch):
        if stats is not None:
            stats.reset()
        if regather:
            batch = {k: row_group.all_gather(
                v, 1 if k == "positions" and v.dim() == 3 else 0)
                for k, v in batch.items()}
        with context():
            logits, caches = forward(params, caches, batch)
        if regather:
            n = logits.shape[0] // row_group.size
            logits = logits[row_group.rank * n:(row_group.rank + 1) * n]
        return logits, caches

    prefill_step.stats = stats
    return prefill_step, (p_specs, c_specs, b_specs)


# ---------------------------------------------------------------------------
# serving: retrieval-augmented decode
# ---------------------------------------------------------------------------

def build_serve_step(spec: ArchSpec, shape_name: str, mesh,
                     db: Optional[specs_lib.ServeDBSpec] = None,
                     with_retrieval: bool = True, group=None):
    """The paper's token-generation step (Fig. 3). Returns
    ``(serve_step, shardings, (db_cfg, structs))``.

    ``serve_step(params, caches, batch, db_params, db_shard, payload[,
    proj]) -> (logprobs or logits [B, V], caches)``: ``decode_step`` with
    the hidden state, the query (projected by ``proj`` when the model is
    wider than the index), the search, then the kNN-LM mix of the
    neighbours' next tokens; a RETRO encoder-decoder instead gathers the
    neighbours' chunks, embeds and encodes them, and decodes the step
    again over the new encoder states.

    The search is the local pipeline over the stacked shards ``db_shard``
    (leading axis: the shards): the IVF probe, the LUTs, one fused scan
    keeping k' per shard, and ``flat_merge`` to the K nearest
    (``retrieval.service.search_stacked``). It goes around
    ``RetrievalService``, whose result cache reads the queries on the
    host. The step calls it as ``serve_step.search(db_params,
    db_shard, queries) -> (dists [nq, K], ids [nq, K])``, where a caller
    can run it alone or observe it. ``payload`` is the next-token table
    [N] (kNN-LM) or the chunk table [N, chunk_len] (RETRO).

    With a ``group`` of more than one rank (the module docstring) the
    search is ``router.build_mesh_search`` over the rank's one DB shard
    and the whole batch's queries (all-gathered over the data axes where
    the rows split over them), the payload gather
    ``router.build_mesh_gather``, and each rank mixes its rows and
    vocabulary columns (``rag.knnlm_interpolate`` with the model axis's
    reducers)."""
    cfg = spec.model
    rag = spec.rag
    B = SHAPES[shape_name]["global_batch"]
    dp = dp_axes(mesh)
    db = db or specs_lib.ServeDBSpec()
    n_shards = specs_lib.num_db_shards(mesh)
    ccfg = db.for_model(cfg, n_shards, rag.k)
    dq = ccfg.ivfpq.dim
    needs_proj = cfg.d_model != dq
    retro = rag.mode == "retro" and cfg.arch == "encdec"
    group = _serving_group(mesh, group)

    kv_batch = "dp" if B >= 8 else None
    kv_seq = "model" if B >= 8 else ("dp", "model")

    p_struct = abstract_params(cfg)
    p_specs = sanitize(param_specs(cfg, mesh, p_struct), p_struct, mesh)
    c_struct = specs_lib.cache_struct(spec, shape_name)
    c_specs = sanitize(cache_specs(cfg, mesh, c_struct, shard_seq=(B < 8)),
                       c_struct, mesh)
    b_specs: Dict[str, Any] = {"token": P(dp, None), "position": P(dp)}
    if cfg.arch == "encdec":
        b_specs["enc_states"] = P(dp, None, None)
    if B < 8:  # long_500k: the batch is too small to shard
        b_specs = {"token": P(), "position": P()}
        if cfg.arch == "encdec":
            b_specs["enc_states"] = P(None, None, "model")
    structs: Dict[str, Any] = dict(
        cache=c_struct, batch=specs_lib.decode_struct(spec, shape_name))
    shardings: Dict[str, Any] = dict(params=p_specs, caches=c_specs,
                                     batch=b_specs)
    if with_retrieval:
        dbp_struct, dbs_struct = specs_lib.db_struct(ccfg, n_shards)
        dbp_specs, dbs_specs = specs_lib.db_specs(mesh)
        if retro:
            payload_struct = specs_lib.S((db.n_vectors, rag.chunk_len),
                                         torch.int32)
            payload_spec = P(dp + ("model",), None)
        else:
            payload_struct = specs_lib.S((db.n_vectors,), torch.int32)
            payload_spec = P(dp + ("model",))
        shardings.update(db_params=dbp_specs, db_shard=dbs_specs,
                         payload=payload_spec)
        structs.update(db_params=dbp_struct, db_shard=dbs_struct,
                       payload=payload_struct)
        if needs_proj:
            shardings["proj"] = P(None, "model")
            structs["proj"] = specs_lib.S((cfg.d_model, dq), torch.float32)

    if group is None:
        def search(db_params, db_shard, query):
            return search_stacked(db_params, db_shard, query, ccfg)

        def context():
            return activation_sharding(dp, "model", kv_batch=kv_batch,
                                       kv_seq=kv_seq)
        gather = rag_lib.gather_payload
        rows, row_group, proj_cols, stats = (), None, None, None
    else:
        # what the rank holds: the specs as put_named lays them out
        held = sanitize({k: shardings[k] for k in shardings
                         if k not in ("params", "caches")},
                        {k: structs[k] for k in shardings
                         if k not in ("params", "caches")}, mesh)
        search = gather = None
        if with_retrieval:
            search = router_lib.build_mesh_search(group, ccfg, nq=B,
                                                  db_axes=dp)
            gather = router_lib.build_mesh_gather(group,
                                                  _axes(held["payload"]))
        rows = _axes(held["batch"]["token"])
        row_group = group.over(rows)
        proj_cols = group.over(_axes(held.get("proj", P()), 1))
        stats = _Stats(group)
        context = _sharded_context(group, dp, kv_batch, kv_seq, p_specs,
                                   c_specs, B if rows else None)

    def my_rows(t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over the whole batch."""
        if not rows:
            return t
        n = t.shape[0] // row_group.size
        return t[row_group.rank * n:(row_group.rank + 1) * n]

    @torch.no_grad()
    def serve_step(params, caches, batch, db_params=None, db_shard=None,
                   payload=None, proj=None):
        if stats is not None:
            stats.reset()
        token, position = batch["token"], batch["position"]
        with context():
            logits, caches, hidden = tf.decode_step(
                params, cfg, caches, token, position,
                enc_states=batch.get("enc_states"), return_hidden=True)
            if not with_retrieval:
                return logits, caches
            query = hidden.float()
            if needs_proj:
                query = query @ proj
                if proj_cols is not None:
                    query = proj_cols.all_gather(query.contiguous(), 1)
            if rows:
                query = row_group.all_gather(query.contiguous(), 0)
            dists, ids = serve_step.search(db_params, db_shard, query)
            if retro:
                chunks = my_rows(rag_lib.retro_neighbor_tokens(
                    payload, ids) if group is None else torch.where(
                    (ids >= 0)[..., None], gather(payload, ids), 0))
                emb = tf.embed_tokens(params,
                                      chunks.reshape(chunks.shape[0], -1))
                new_enc = tf.encode(params, cfg, emb)
                logits2, caches, _ = tf.decode_step(
                    params, cfg, caches, token, position, enc_states=new_enc,
                    return_hidden=True)
                return logits2, caches
            knn_tok = gather(payload, ids)
            knn_tok = my_rows(torch.where(ids >= 0, knn_tok,
                                          torch.full_like(knn_tok, -1)))
            dists = my_rows(dists)
            # this rank's vocabulary columns where the head splits them
            split = logits.shape[-1] != cfg.vocab_size
            logp = rag_lib.knnlm_interpolate(
                logits, dists, knn_tok, rag.lam, rag.temperature,
                parallel.model_rank() * logits.shape[-1] if split else 0,
                parallel.max_over_model if split else None,
                parallel.reduce_from_model if split else None)
        return logp, caches

    serve_step.search = search
    serve_step.stats = stats
    return serve_step, shardings, (ccfg, structs)
