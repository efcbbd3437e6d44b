"""The dry run's spec calculus against the JAX package, on the CPU, for
all 14 registered models at their full configs:

  * ``sharding.param_specs``, ``cache_specs`` (both sequence layouts)
    and ``sanitize`` give the reference's spec trees, leaf for leaf, on
    the 16 x 16 and 2 x 16 x 16 production meshes and on 2 x 2 (the
    reference runs against a stand-in mesh object, its ``axis_names``
    and ``devices.shape``, as it reads nothing else);
  * ``sharding.shard_shape`` equals jax's ``NamedSharding.shard_shape``
    over an ``AbstractMesh`` of the same axes;
  * every ``launch.specs`` struct (train batch, prefill batch, decode
    batch, caches, the database) has the reference's shapes and dtypes
    for every model and shape that applies, the train batch's specs are
    the reference's, and ``ServeDBSpec.for_model`` the reference's
    fields;
  * ``mesh.make_production_mesh`` has the reference's axes and sizes on
    meta positions.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jax_arch
from repro.launch import specs as jspecs
from repro.models import sharding as jsharding
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import sharding as tsharding

ARCHS = list_archs(include_paper=True)
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2))}


def meshes(name):
    axes, dims = MESHES[name]
    stand_in = types.SimpleNamespace(
        axis_names=axes, devices=np.empty(dims, dtype=object),
        shape=dict(zip(axes, dims)))
    return stand_in, Mesh(axes, dims, ("meta",) * int(np.prod(dims)))


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)


def jax_keyed(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {_key(p): tuple(v) if isinstance(v, JP) else v
            for p, v in leaves}


def port_keyed(tree, prefix=()) -> dict:
    if isinstance(tree, tsharding.PartitionSpec):
        return {"/".join(prefix): tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_keyed(v, prefix + (str(k),)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(port_keyed(v, prefix + (f,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_keyed(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def shapes_of(tree) -> dict:
    """Leaf key -> (shape, dtype name) of a tree of jax structs or of the
    port's meta tensors."""
    if isinstance(tree, (dict, tuple, list)):
        items = (tree.items() if isinstance(tree, dict)
                 else zip(tree._fields, tree) if hasattr(tree, "_fields")
                 else enumerate(tree))
        out = {}
        for k, v in items:
            out.update({f"{k}/{kk}" if kk else str(k): vv
                        for kk, vv in shapes_of(v).items()})
        return out
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return {"": (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    return {"": (tuple(tree.shape), str(tree.dtype))}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_cache_specs_match_the_reference(mesh_name):
    jm, tm = meshes(mesh_name)
    for arch in ARCHS:
        jspec, tspec = jax_arch(arch), get_arch(arch)
        cfg, tcfg = jspec.model, tspec.model
        jp = jsharding.param_specs(cfg, jm)
        p_struct = tsteps.abstract_params(tcfg)
        tp = tsharding.param_specs(tcfg, tm, p_struct)
        assert port_keyed(tp) == jax_keyed(jp), arch
        j_struct = jsharding._as_shape_tree(cfg)
        assert port_keyed(tsharding.sanitize(tp, p_struct, tm)) == \
            jax_keyed(jsharding.sanitize(jp, j_struct, jm)), arch
        for shape in ("decode_32k", "long_500k"):
            jc = jspecs.cache_struct(jspec, shape)
            tc = tspecs.cache_struct(tspec, shape)
            for seq in (False, True):
                jcs = jsharding.cache_specs(cfg, jm, jc, shard_seq=seq)
                tcs = tsharding.cache_specs(tcfg, tm, tc, shard_seq=seq)
                assert port_keyed(tcs) == jax_keyed(jcs), (arch, seq)
                assert port_keyed(tsharding.sanitize(tcs, tc, tm)) == \
                    jax_keyed(jsharding.sanitize(jcs, jc, jm)), (arch, seq)
        assert tsharding.dp_axes(tm) == jsharding.dp_axes(jm)


def test_shard_shape_matches_named_sharding():
    """Shapes and specs of the dry run's kind ("dp" stands for the
    mesh's data-parallel axes)."""
    cases = [((50_000, 512), ("model", "dp")),
             ((126, 16384, 2048), (None, "dp", "model")),
             ((32, 128, 2048, 8, 128), (None, "dp", "model", None, None)),
             ((1_000_000_000,), ("dp+model",)),
             ((3, 256, 4096), (None, "dp", None)),
             ((7,), ())]
    for name in ("16x16", "2x16x16", "2x2"):
        axes, dims = MESHES[name]
        _, tm = meshes(name)
        dp = tsharding.dp_axes(tm)
        am = AbstractMesh(dims, axes)
        for shape, template in cases:
            entries = tuple(dp if e == "dp" else dp + ("model",)
                            if e == "dp+model" else e for e in template)
            want = NamedSharding(am, JP(*entries)).shard_shape(shape)
            got = tsharding.shard_shape(shape, tsharding.P(*entries), tm)
            assert got == tuple(want), (name, shape, entries)
        # a spec that does not divide raises, as jax's does
        with pytest.raises(ValueError):
            tsharding.shard_shape((31, 4), tsharding.P("model"), tm)
        with pytest.raises(ValueError):
            NamedSharding(am, JP("model")).shard_shape((31, 4))


def test_structs_match_the_reference():
    for arch in ARCHS:
        jspec, tspec = jax_arch(arch), get_arch(arch)
        for shape in tspec.applicable_shapes():
            assert shapes_of(tspecs.train_batch_struct(tspec, shape)) == \
                shapes_of(jspecs.train_batch_struct(jspec, shape))
            assert shapes_of(tspecs.prefill_struct(tspec, shape)) == \
                shapes_of(jspecs.prefill_struct(jspec, shape))
            assert shapes_of(tspecs.decode_struct(tspec, shape)) == \
                shapes_of(jspecs.decode_struct(jspec, shape))
            assert shapes_of(tspecs.cache_struct(tspec, shape)) == \
                shapes_of(jspecs.cache_struct(jspec, shape)), (arch, shape)
        for name in ("16x16", "2x16x16"):
            jm, tm = meshes(name)
            assert port_keyed(tspecs.train_batch_specs(tspec, "train_4k",
                                                       tm)) == \
                jax_keyed(jspecs.train_batch_specs(jspec, "train_4k", jm))


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_db_specs_and_for_model_match_the_reference(mesh_name):
    jm, tm = meshes(mesh_name)
    n = jspecs.num_db_shards(jm)
    assert tspecs.num_db_shards(tm) == n == (16 if mesh_name == "16x16"
                                             else 32)
    assert port_keyed(tspecs.db_specs(tm)) == jax_keyed(jspecs.db_specs(jm))
    jdb, tdb = jspecs.ServeDBSpec(), tspecs.ServeDBSpec()
    for arch in ARCHS:
        cfg = get_arch(arch).model
        k = get_arch(arch).rag.k
        jc = jdb.for_model(jax_arch(arch).model, n, k)
        tc = tdb.for_model(cfg, n, k)
        assert dataclasses.asdict(tc.ivfpq) == dataclasses.asdict(jc.ivfpq)
        assert (tc.nprobe, tc.k, tc.eps) == (jc.nprobe, jc.k, jc.eps)
        assert shapes_of(tspecs.db_struct(tc, n)) == \
            shapes_of(jspecs.db_struct(jc, n)), arch


def test_production_mesh():
    for multi, dims in ((False, (16, 16)), (True, (2, 16, 16))):
        m = make_production_mesh(multi_pod=multi)
        assert m.dims == dims and m.size == int(np.prod(dims))
        assert m.axis_names == (("pod", "data", "model") if multi
                                else ("data", "model"))
        assert set(m.devices) == {"meta"}
        assert tsharding.dp_axes(m) == (("pod", "data") if multi
                                        else ("data",))


def test_spec_entries_normalise_as_jax_does():
    for entries in [((), "model"), (("a",),), (["a", "b"], None),
                    ("a", None, None), (None,)]:
        assert tuple(tsharding.P(*entries)) == tuple(JP(*entries))
