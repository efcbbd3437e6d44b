"""Partition rules (twin of ``repro.models.sharding``): FSDP over
("pod", "data"), tensor parallelism over "model", expert parallelism
over "data" for MoE experts.

``param_specs``, ``cache_specs`` and ``sanitize`` compute, for the
port's parameter and cache trees, the reference's GSPMD partition specs
over a ``launch.mesh.Mesh`` (only its axis names and sizes are read),
and ``shard_shape`` the per-device local shape a spec gives
(``NamedSharding.shard_shape``). The dry run (``launch/dryrun.py``) sums
those local shapes into its per-device argument bytes.

Placing: the reference's ``put_named`` lays a tree out over the devices
of one program. Here each mesh position is a training rank of its own
(``launch.dp``), and ``put_named(tree, specs, mesh, group)`` runs on
every rank: the rank keeps the slice of every leaf that its coordinates
select, so it holds exactly the bytes the dry run counts for one device.
``gather_named`` is its inverse (whole leaves on every rank, for a
checkpoint in the reference's layout). The sharded train step
(``launch.steps.build_train_step``) computes on such shards.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.models.config import ModelConfig


class PartitionSpec(tuple):
    """A partition spec: one entry per leading dimension, each ``None``
    (replicated), an axis name, or a tuple of axis names (sharded over
    their product); trailing dimensions left out are replicated. Entries
    are normalised as jax normalises them (an empty tuple is ``None``, a
    one-name tuple is the name), so as a tuple it equals
    ``tuple(jax.sharding.PartitionSpec(...))`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _canon(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else (entry[0] if len(entry) == 1
                                       else entry)
    return entry


def dp_axes(mesh) -> Tuple[str, ...]:
    """The compound FSDP / batch axis: ("pod", "data") when multi-pod."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _block_rules(dp, ep_axis: Optional[str], pod_axis: Optional[str]
                 ) -> Dict[str, P]:
    """Specs of the stacked per-layer leaves ([L, ...]: the layer axis
    unsharded), by leaf name."""
    return {
        # attention
        "ln1": P(), "ln2": P(), "lnx": P(),
        "wq": P(None, dp, "model"), "wk": P(None, dp, "model"),
        "wv": P(None, dp, "model"), "wo": P(None, "model", dp),
        "bq": P(None, "model"), "bk": P(None, "model"), "bv": P(None, "model"),
        "xwq": P(None, dp, "model"), "xwk": P(None, dp, "model"),
        "xwv": P(None, dp, "model"), "xwo": P(None, "model", dp),
        # dense MLP (3-D); the MoE's 4-D experts are param_specs' own
        "wg": P(None, dp, "model"), "wu": P(None, dp, "model"),
        "wd": P(None, "model", dp),
        "router": P(None, dp, None),
        # the hybrid's Mamba head
        "w_in": P(None, dp, "model"), "conv_w": P(None, None, "model"),
        "w_bcdt": P(None, "model", None), "a_log": P(), "dt_bias": P(),
        "d_skip": P(), "w_out": P(None, "model", dp),
        "ln_attn_out": P(), "ln_ssm_out": P(),
        # RWKV-6
        "mu_r": P(), "mu_k": P(), "mu_v": P(), "mu_g": P(), "mu_w": P(),
        "w_r": P(None, dp, "model"), "w_k": P(None, dp, "model"),
        "w_v": P(None, dp, "model"), "w_g": P(None, dp, "model"),
        "w_o": P(None, "model", dp),
        "w0": P(None, "model"), "w_lora_a": P(None, dp, None),
        "w_lora_b": P(None, None, "model"),
        "bonus_u": P(), "ln_x": P(None, "model"),
        "mu_ck": P(), "mu_cr": P(),
        "w_ck": P(None, dp, "model"), "w_cv": P(None, "model", dp),
        "w_cr": P(None, dp, "model"),
    }


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_named(fn, tree, name=None):
    """``fn(leaf_name, leaf)`` over a tree of dicts, NamedTuples and
    sequences; a leaf's name is its dict key or NamedTuple field."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_named(fn, v, f)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def _map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure;
    a ``PartitionSpec`` is a leaf, as anything not a container is."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        out = [_map_specs(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(specs)]
        return type(specs)(*out) if _is_namedtuple(specs) \
            else type(specs)(out)
    return fn(specs, *rest)


def param_specs(cfg: ModelConfig, mesh, params: Any = None) -> Any:
    """The spec tree of ``transformer.init_params``'s output: by leaf
    name, the MoE's 4-D experts over (layer, expert = "data", d = "pod",
    f = "model"). ``params`` (default: the abstract params on meta) only
    supplies the tree and the leaves' ranks."""
    dp = dp_axes(mesh)
    ep = "data" if "data" in mesh.axis_names else None
    pod = "pod" if "pod" in mesh.axis_names else None
    rules = _block_rules(dp, ep, pod)
    moe_rules = {
        "wg": P(None, ep, pod, "model"), "wu": P(None, ep, pod, "model"),
        "wd": P(None, ep, "model", pod),
    }

    def spec_of(name, leaf) -> P:
        if name == "embed":
            return P("model", dp)
        if name == "lm_head":
            return P(dp, "model")
        if name == "final_norm":
            return P()
        if leaf.dim() == 4 and name in moe_rules:
            return moe_rules[name]
        return rules.get(name, P())

    if params is None:
        from repro_torch.models import transformer as tf
        params = tf.init_params(None, cfg)
    return _map_named(spec_of, params)


def cache_specs(cfg: ModelConfig, mesh, cache_tree,
                shard_seq: bool = False) -> Any:
    """Specs of the decode caches. K/V are sharded batch over dp and
    sequence over "model" (split-KV, flash-decode style), never over
    heads: several models have fewer KV heads than the 16-way model
    axis. ``shard_seq`` (a batch of 1, long_500k) puts the sequence over
    the dp axes as well."""
    dp = dp_axes(mesh)

    def spec_of(name, leaf) -> P:
        if name in ("k", "v", "xk", "xv"):      # [Lc, B, S, KV, dh]
            if shard_seq:
                return P(None, None, dp + ("model",), None, None)
            return P(None, dp, "model", None, None)
        if name in ("wkv", "ssm"):               # [Lc, B, H, dh, dh | ds]
            return P(None, dp, "model", None, None)
        if name == "conv":                       # [Lc, B, cw-1, d_in]
            return P(None, dp, None, "model")
        if name in ("st", "sc"):                 # [Lc, B, d]
            return P(None, dp, None)
        return P()

    return _map_named(spec_of, cache_tree)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def sanitize(spec_tree, struct_tree, mesh):
    """Drop sharding on dimensions the mesh cannot divide evenly
    (d_ff 1368, vocab 256 206 on a 16-way axis): a compound entry loses
    its leading axes (("pod", "data") -> ("data",)) before it gives up.
    Trailing replicated entries are dropped, as the reference drops
    them."""
    sizes = _axis_sizes(mesh)

    def fix_leaf(spec, leaf):
        if not isinstance(spec, PartitionSpec):
            return spec
        dims = getattr(leaf, "shape", None)
        if dims is None:
            return spec
        out = []
        for i, entry in enumerate(spec):
            if entry is None or i >= len(dims):
                out.append(None if i >= len(dims) else entry)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            while axes:
                if dims[i] % math.prod(sizes.get(a, 1) for a in axes) == 0:
                    break
                axes = axes[1:]
            out.append(tuple(axes) if len(axes) > 1
                       else (axes[0] if axes else None))
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    return _map_specs(fix_leaf, spec_tree, struct_tree)


def keyed_specs(specs) -> Dict[str, PartitionSpec]:
    """Tree key (``repro_torch.tree``'s) -> spec of a spec tree."""
    from repro_torch import tree as tree_lib
    keys = list(tree_lib.keyed(_map_specs(lambda s: 0, specs)))
    return dict(zip(keys, spec_leaves(specs)))


def spec_leaves(specs) -> list:
    """The specs of a spec tree, in ``tree.leaves`` order."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for v in specs for s in spec_leaves(v)]


def _shard_index(entry, sizes: Dict[str, int], coords: Dict[str, int]
                 ) -> Tuple[int, int]:
    """(index of this position's shard along a dim, number of shards):
    a compound entry is row-major over its axes, as jax lays it out."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coords.get(a, 0)
        n *= sizes[a]
    return idx, n


def put_named(tree, specs, mesh, group):
    """This rank's shard of every leaf of ``tree`` (whole leaves, on any
    device) under ``specs`` over ``mesh``: each dim split over axes keeps
    the slice that ``group``'s coordinates select, copied onto the
    rank's device. Raises where a dim does not divide (as
    ``shard_shape``)."""
    sizes, coords = _axis_sizes(mesh), group.coords
    if dict(sizes) != dict(group.shape):
        raise ValueError(f"mesh {sizes} is not the rank group's "
                         f"{group.shape}")

    def place(spec, leaf):
        local = shard_shape(leaf.shape, spec, mesh)
        for dim, entry in enumerate(spec):
            if entry is not None:
                idx, _ = _shard_index(entry, sizes, coords)
                leaf = leaf.narrow(dim, idx * local[dim], local[dim])
        return leaf.to(group.device, copy=True).contiguous()

    return _map_specs(place, specs, tree)


def gather_named(tree, specs, mesh, group):
    """Whole leaves on every rank from each rank's shards (``put_named``'s
    inverse): each split dim all-gathered over its axes (a dim split over
    "data" and "model" over the whole mesh, in rank order: the row-major
    order ``put_named`` slices by). Every rank of ``group`` must call
    it."""
    def whole(spec, leaf):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            if any(mesh.shape[a] > 1 for a in axes):
                leaf = group.over(axes).all_gather(leaf, dim)
        return leaf.contiguous()

    return _map_specs(whole, specs, tree)


def shard_shape(shape: Sequence[int], spec: PartitionSpec, mesh
                ) -> Tuple[int, ...]:
    """The per-device local shape of a ``shape`` array laid out by
    ``spec`` over ``mesh``: each sharded dimension divided by the product
    of its axes' sizes. Raises when a dimension does not divide, as
    ``NamedSharding.shard_shape`` does."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes)
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} is not "
                             f"divisible by {n} (spec {spec})")
        out[i] //= n
    return tuple(out)
