"""Shard placement, query broadcast and result gather over the retrieval
pool (twin of ``repro.retrieval.router``).

The reference runs one ``shard_map`` program over a device mesh: the
queries are split over the ``model`` columns, each device probes and
scans its DB shard, the k'-truncated survivors are all-gathered and
merged on every device. Here each mesh position is a memory-node
process (``retrieval/fabric.py``) and the caller is the coordinator: it
sends each node its queries, each node probes (the IVF probe kernel)
and scans its shard (``adc_scan``, through ``core.chamvs.shard_search``)
on its own device and sends back its survivors [nq_local, k'] through
host memory, and the coordinator merges them once, on the queries'
device: the paper's coordinator merge. The answer is the reference's:
the survivors concatenated in producer order, then the first K of a
stable ascending sort.

  * ``build_search(mesh, cfg, ...)`` — the distributed search;
  * ``build_gather(mesh, axes)`` — id -> payload against a table sharded
    over ``axes``: each slice's node gathers the ids in its row range and
    masks the others to 0, and the coordinator sums the slices (KB a
    call, never the table);
  * ``ShardRouter`` — owns the nodes (one ``Fabric``) and places the
    quantizers, the DB shards and the payload tables on them. A
    placement is a ``Placed`` handle naming what lives on the nodes; the
    search and gather callables take handles where the reference's take
    placed arrays.

A router owns processes, so it has ``close()`` and is a context manager:
lifetime management that the reference's single controller never needed.

``build_mesh_search`` and ``build_mesh_gather`` are the same search and
gather inside a sharded serve step (``launch.steps.build_serve_step``
with a rank group), the twin of the reference's ``shard_map`` bodies:
every rank of a ``launch.dp.Group`` runs them on its own shards, data
rank d scanning its one DB shard, and the group's collectives stand in
for the fabric.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.core.ivfpq import IVFPQParams, IVFPQShard
from repro_torch.launch.mesh import Mesh
from repro_torch.retrieval.fabric import Fabric
from repro_torch.retrieval.merge import flat_merge


@dataclasses.dataclass(frozen=True)
class Placed:
    """Tensors placed on a fabric's nodes under ``name``: split along
    their leading axis over the mesh ``axes`` (``nloc`` leading rows a
    slice; every node of a slice holds it), or on every node when
    ``axes`` is empty."""
    fabric: Fabric
    name: str
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    nloc: int = 0


def num_db_shards(mesh: Mesh, db_axes: Tuple[str, ...]) -> int:
    """Memory-node count along the db axes present in ``mesh``."""
    return math.prod(mesh.shape[a] for a in db_axes if a in mesh.axis_names)


def _axes_in(mesh: Mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in mesh.axis_names)


def _slice_of(mesh: Mesh, pos: int, axes: Tuple[str, ...]) -> int:
    """Row-major index of position ``pos`` over ``axes``."""
    c = mesh.coords(pos)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + c[a]
    return idx


def _node_at(mesh: Mesh, axes: Tuple[str, ...], idx: int,
             **fixed: int) -> int:
    """The position whose coordinates over ``axes`` flatten to ``idx``
    (row-major), with ``fixed`` coordinates and every other axis at 0."""
    coords = dict(fixed)
    for a in reversed(axes):
        idx, coords[a] = divmod(idx, mesh.shape[a])
    return mesh.position(coords)


def place(fabric: Fabric, mesh: Mesh, parts: Sequence[Sequence[torch.Tensor]],
          axes: Tuple[str, ...], shape: Tuple[int, ...], nloc: int = 0,
          prefix: str = "obj") -> Placed:
    """Send ``parts[s]`` to every node of slice ``s`` over ``axes`` (one
    part, to every node, when ``axes`` is empty)."""
    name = fabric.new_name(prefix)
    fabric.call("place", {pos: ({"name": name},
                                parts[_slice_of(mesh, pos, axes)])
                          for pos in range(mesh.size)})
    return Placed(fabric, name, axes, tuple(shape), nloc)


def place_params(fabric: Fabric, mesh: Mesh, params: IVFPQParams) -> Placed:
    """The quantizers are metadata: a copy on every node."""
    return place(fabric, mesh, [list(params)], (),
                 tuple(params.coarse_centroids.shape), prefix="params")


def place_table(fabric: Fabric, mesh: Mesh, table: torch.Tensor,
                axes: Sequence[str]) -> Placed:
    """A table split in equal row slices over ``axes`` (the counterpart
    of ``jax.device_put`` with ``P(axes)``); rows must divide evenly."""
    axes = _axes_in(mesh, axes)
    n = num_db_shards(mesh, axes)
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} rows do not split over {n} "
                         f"slices of {axes}")
    nloc = table.shape[0] // n
    return place(fabric, mesh, [[t] for t in table.split(nloc)], axes,
                 tuple(table.shape), nloc, prefix="table")


def release(placed: Placed) -> None:
    """Drop a placement from its nodes."""
    placed.fabric.broadcast("drop", {"names": [placed.name]})


def build_search(mesh: Mesh, cfg: ChamVSConfig,
                 db_axes: Tuple[str, ...] = ("data",),
                 query_axis: Optional[str] = "model",
                 nq: Optional[int] = None):
    """The distributed search over ``mesh``: ``search(params, stacked,
    queries) -> (dists [nq, K], ids [nq, K])`` on the queries' device.
    ``stacked`` is the DB placed one shard per slice of the db axes
    (``ShardRouter.place_shards``); ``params`` a ``Placed`` copy of the
    quantizers, or plain ``IVFPQParams``, sent along with the call.

    Work split over ``query_axis`` (the columns of each shard row):
      * query split: each column searches nq / qsize of the queries;
      * probe split, when ``nq`` does not divide (e.g. batch 1) but
        nprobe does: each column scans nprobe / qsize of every query's
        probed lists, and the merge spans shards x columns."""
    db_axes = _axes_in(mesh, db_axes)
    num_shards = num_db_shards(mesh, db_axes)
    qa = query_axis if (query_axis and query_axis in mesh.axis_names) \
        else None
    qsize = mesh.shape[qa] if qa else 1
    probe_split = bool(qa) and nq is not None and (
        nq % qsize != 0 and cfg.nprobe % qsize == 0)
    producers = num_shards * (qsize if probe_split else 1)
    kk = cfg.k_prime(producers)
    cfg_meta = dataclasses.asdict(cfg)

    def search(params, stacked: Placed, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if stacked.axes != db_axes:
            raise ValueError(f"shards placed over {stacked.axes}, the "
                             f"search splits over {db_axes}")
        n = queries.shape[0]
        if qa and not probe_split:
            assert n % qsize == 0, (n, qsize)
        fabric = stacked.fabric
        own = not isinstance(params, Placed)
        if own:
            params = place_params(fabric, mesh, params)
        meta = {"params": params.name, "shard": stacked.name,
                "cfg": cfg_meta, "kk": kk, "probe": None}
        q = queries.float().contiguous().cpu()
        # producers in the merge's order: shard-major, then column
        reqs: Dict[int, Tuple[dict, List[torch.Tensor]]] = {}
        order: List[List[int]] = []
        for s in range(num_shards):
            row = []
            for c in range(qsize if qa else 1):
                pos = _node_at(mesh, db_axes, s, **({qa: c} if qa else {}))
                if probe_split:
                    npl = cfg.nprobe // qsize
                    reqs[pos] = (dict(meta, probe=[c * npl, npl]), [q])
                elif qa:
                    nql = n // qsize
                    reqs[pos] = (meta, [q[c * nql:(c + 1) * nql]])
                else:
                    reqs[pos] = (meta, [q])
                row.append(pos)
            order.append(row)
        try:
            out = fabric.call("search", reqs)
        finally:
            if own and not fabric.closed:
                release(params)
        if probe_split:          # one producer per (shard, column)
            d = [out[p][1][0] for row in order for p in row]
            i = [out[p][1][1] for row in order for p in row]
        else:                    # a shard's columns hold its row blocks
            d = [torch.cat([out[p][1][0] for p in row]) for row in order]
            i = [torch.cat([out[p][1][1] for p in row]) for row in order]
        dev = queries.device
        return flat_merge(torch.stack(d).to(dev), torch.stack(i).to(dev),
                          cfg.k)

    return search


def build_mesh_search(group, cfg: ChamVSConfig, nq: int,
                      db_axes: Tuple[str, ...] = ("data",),
                      query_axis: str = "model"):
    """The reference's ``build_search`` body on a rank of ``group``:
    ``search(params, shard, queries) -> (dists [nq, K], ids [nq, K])``,
    the same on every rank. ``shard`` is this rank's slice of the
    stacked DB (leading axis 1: the shard of its coordinate over
    ``db_axes``); ``queries`` [nq, D] are the whole batch's.

    The rank probes its queries (the IVF probe kernel), computes their
    LUTs and runs one fused scan over its shard keeping k' =
    ``cfg.k_prime(producers)``. The work splits over ``query_axis``:
    each column takes nq / M of the queries (the query split), or, when
    nq does not divide and nprobe does (a batch of 1), nprobe / M of
    every query's probed lists (the probe split). The survivors of every
    producer are all-gathered in the reference's order (over the db axes,
    and the column too under the probe split: rank order), merged by a
    stable ascending sort, and the query split is undone."""
    from repro_torch.kernels.chamvs_scan.ops import fused_shard_scan
    from repro_torch.kernels.ivf_scan.ops import ivf_index_scan
    db = group.over(db_axes)
    M = group.shape.get(query_axis, 1)
    col = group.coords.get(query_axis, 0)
    probe_split = M > 1 and nq % M != 0 and cfg.nprobe % M == 0
    if M > 1 and not probe_split and nq % M:
        raise ValueError(f"{nq} queries split neither by query nor by "
                         f"probe ({cfg.nprobe}) over {M} columns")
    producers = db.size * (M if probe_split else 1)
    kk = cfg.k_prime(producers)
    merge_group = group if probe_split else db

    def search(params, shard, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if shard.codes.shape[0] != 1:
            raise ValueError(f"a rank scans one shard, got "
                             f"{shard.codes.shape[0]}")
        q = queries.float()
        if M > 1 and not probe_split:
            n = nq // M
            q = q[col * n:(col + 1) * n]
        _, probe_ids = ivf_index_scan(q, params.coarse_centroids, cfg.nprobe)
        if probe_split:
            npl = cfg.nprobe // M
            probe_ids = probe_ids[:, col * npl:(col + 1) * npl].contiguous()
        d, i = fused_shard_scan(params, shard, q, probe_ids, cfg, kk)
        d = merge_group.all_gather(d.contiguous(), 0)
        i = merge_group.all_gather(i.contiguous(), 0)
        d, i = flat_merge(d, i, cfg.k)
        if M > 1 and not probe_split:
            cols = group.axis(query_axis)
            d, i = cols.all_gather(d, 0), cols.all_gather(i, 0)
        return d, i

    search.kk, search.probe_split = kk, probe_split
    return search


def build_mesh_gather(group, table_axes: Tuple[str, ...]):
    """Id -> payload inside a sharded step: ``gather(table, ids)`` with
    ``table`` this rank's row slice of a table split over ``table_axes``
    (row-major over them) and ``ids`` the same on every rank. Each rank
    looks up the ids in its row range, zeros the others, and the slices'
    results are summed over the ranks that split the table."""
    over = group.over(table_axes)

    def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        n = table.shape[0]
        rel = ids.long() - over.rank * n
        hit = (rel >= 0) & (rel < n)
        vals = table[rel.clamp(0, n - 1)]
        hit = hit.reshape(hit.shape + (1,) * (vals.dim() - hit.dim()))
        return over.all_reduce(torch.where(hit, vals, 0).contiguous())

    return gather


def build_gather(mesh: Mesh, table_axes: Tuple[str, ...]):
    """Id -> payload against a table placed over ``table_axes``:
    ``gather(table, ids)`` -> ``table[ids]`` on the ids' device. Each
    slice's node gathers the ids in its row range and masks the others
    to 0; the coordinator sums the slices, so an id outside the table
    gives 0."""
    axes = _axes_in(mesh, table_axes)
    n = num_db_shards(mesh, axes)

    def gather(table: Placed, ids: torch.Tensor) -> torch.Tensor:
        if table.axes != axes:
            raise ValueError(f"table placed over {table.axes}, the gather "
                             f"reads {axes}")
        h = ids.contiguous().cpu()
        out = table.fabric.call(
            "gather", {_node_at(mesh, axes, s):
                       ({"table": table.name, "lo": s * table.nloc}, [h])
                       for s in range(n)})
        parts = [t[0] for _, t in out.values()]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total.to(ids.device)

    return gather


class ShardRouter:
    """Placement + broadcast/gather for one retrieval pool: owns the
    memory nodes (one per mesh position), the node count along the db
    axes, and the search and gather callables. ``DistributedRetriever``
    and ``RouterPipeline`` are thin layers over it."""

    def __init__(self, mesh: Mesh, cfg: ChamVSConfig,
                 db_axes: Tuple[str, ...] = ("data",),
                 query_axis: Optional[str] = "model",
                 nq: Optional[int] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.db_axes = _axes_in(mesh, db_axes)
        self.num_shards = num_db_shards(mesh, db_axes)
        # query split: batches must divide evenly over the columns
        # (callers that batch dynamically pad to this multiple)
        qa = query_axis if (query_axis and
                            query_axis in mesh.axis_names) else None
        self.query_size = mesh.shape[qa] if qa else 1
        self._search = build_search(mesh, cfg, db_axes=db_axes,
                                    query_axis=query_axis, nq=nq)
        self._gather = build_gather(mesh, self.db_axes)
        self.fabric = Fabric(mesh.devices)

    # -- placement ----------------------------------------------------------

    def place_params(self, params: IVFPQParams) -> Placed:
        """Quantizers are metadata: a copy on every memory node."""
        return place_params(self.fabric, self.mesh, params)

    def place_shards(self, shards: List[IVFPQShard]) -> Placed:
        """One DB shard per memory node along the db axes."""
        if len(shards) != self.num_shards:
            raise ValueError(
                f"one shard per memory node: {len(shards)} shards vs "
                f"{self.num_shards} nodes")
        return place(self.fabric, self.mesh, [list(s) for s in shards],
                     self.db_axes, (len(shards),) + tuple(
                         shards[0].codes.shape), 1, prefix="shard")

    def place_table(self, table: Optional[torch.Tensor]
                    ) -> Optional[Placed]:
        """A payload table across the memory nodes, the trailing rows
        padded with zeros so that every node holds an equal slice (the
        padded rows are never addressed: ids < N)."""
        if table is None:
            return None
        rem = (-table.shape[0]) % self.num_shards
        if rem:
            table = torch.cat([table, table.new_zeros(
                (rem,) + tuple(table.shape[1:]))])
        return place_table(self.fabric, self.mesh, table, self.db_axes)

    # -- execution ----------------------------------------------------------

    def search(self, params, stacked: Placed, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._search(params, stacked, queries)

    def gather(self, table: Placed, ids: torch.Tensor) -> torch.Tensor:
        return self._gather(table, ids)

    # -- lifetime -----------------------------------------------------------

    def close(self) -> None:
        """Stop and join the memory nodes."""
        self.fabric.close()

    def __enter__(self) -> "ShardRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
