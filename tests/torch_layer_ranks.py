"""Rank entry of the split-compute layer tests (``launch.dp.launch(...,
"torch_layer_ranks:run", [out_dir, case])``; the tests put this
directory on the ranks' ``PYTHONPATH``).

Each rank builds the same seeded float32 layer of a reduced model, keeps
its shards of the layer's stacked leaves (``put_named`` of the
reference's sanitised specs over the ranks' mesh), and runs the layer in
a sharded training context (``models.ctx.activation_sharding`` with the
mesh group, the specs and the global batch's rows) on its rows of a
seeded input, then the same layer on whole leaves in one process. The
loss is ``sum(out * w)`` over the rank's rows for a seeded ``w``; the
gradients of the input rows and of every stacked leaf's shard are held
against the one-process gradients of the global loss, cut as the rank's
shard. ``rank<r>.json``: ``errors``, name -> [max abs error, max abs of
the one-process tensor]; ``shapes``, what the layer computed with.

Cases: ``moe`` (Phi-3.5-MoE's FFN on tokens near one point, so that the
routing of the global batch drops assignments: ``drops``, counted in one
process), ``mamba`` (Hymba's Mamba head, resumed from a seeded state:
the returned state against the one-process state's heads and channels
of the rank), ``rwkv6`` (an RWKV-6 block, at T 64, chunked, and T 12,
the scan).
"""
import dataclasses
import json
import pathlib

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch
from repro_torch.models import ctx as ctx_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import (keyed_specs, param_specs,
                                         put_named, sanitize)

PREFIX = "classes/global"
ARCHS = {"moe": "phi3_5_moe_42b", "mamba": "hymba_1_5b", "rwkv6": "rwkv6_3b"}
#: the leaves each case's layer reads
LEAVES = {"moe": ("router", "wg", "wu", "wd"), "mamba": ("mamba",),
          "rwkv6": ssm_lib.RWKV6Params._fields + ("ln1", "ln2")}


def cfg_of(case: str):
    return dataclasses.replace(get_arch(ARCHS[case]).reduced,
                               dtype="float32")


def stacked_leaves(case: str, cfg):
    """The layer class's seeded stacked leaves the case reads."""
    params = tf.init_params(torch.Generator().manual_seed(1), cfg)
    return {n: params["classes"]["global"][n] for n in LEAVES[case]}


def moe_input(cfg, B: int, T: int):
    """Tokens near one point: the routing piles up on a few experts."""
    g = torch.Generator().manual_seed(7)
    return torch.randn(1, 1, cfg.d_model, generator=g) + 0.3 * torch.randn(
        B, T, cfg.d_model, generator=g)


def moe_drops(cfg, stacked, x) -> int:
    """Assignments past capacity of the whole batch's routing."""
    p = tf._layer_params(cfg, PREFIX, stacked, 0)
    flat = x.reshape(-1, cfg.d_model)
    E = cfg.n_experts
    _, ids = moe_lib.route_topk(flat, p["router"], cfg.top_k)
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    C = moe_lib.capacity(flat.shape[0], E, cfg.top_k)
    return int((counts - C).clamp(min=0).sum())


def _grad_leaves(tree):
    """``tree``'s tensors, each a fresh leaf that requires grad (the
    NamedTuples rebuilt around them)."""
    return tree_lib.map(lambda t: t.detach().clone().requires_grad_(True),
                        tree)


def _layer(case, cfg, stacked, x):
    """(the layer's output on ``x``, its state or None) in the context in
    force."""
    p = tf._layer_params(cfg, PREFIX, stacked, 0)
    if case == "moe":
        return tf._ffn(cfg, p, x), None
    if case == "mamba":
        mp, split = tf._mamba_params(cfg, p["mamba"])
        B = x.shape[0]
        H, dh, ds = cfg.n_heads, cfg.d_head, cfg.ssm_state
        g = torch.Generator().manual_seed(11)
        prev = (torch.randn(B, H, dh, ds, generator=g),
                torch.randn(B, cfg.conv_width - 1, H * dh, generator=g))
        if split:
            n = mp.a_log.shape[0]
            m = parallel.model_rank()
            prev = (prev[0][:, m * n:(m + 1) * n],
                    prev[1][..., m * n * dh:(m + 1) * n * dh])
        return ssm_lib.mamba_scan(mp, x, prev, split=split)
    return tf._rwkv6_block(cfg, p, x, None, None, {}), None


def run(group, argv):
    out, case = pathlib.Path(argv[0]), argv[1]
    cfg = cfg_of(case)
    mesh = group.mesh
    whole = stacked_leaves(case, cfg)
    struct = tf.init_params(None, cfg)
    specs = sanitize(param_specs(cfg, mesh, struct), struct, mesh)
    stacked_specs = {n: specs["classes"]["global"][n] for n in whole}
    keyed = keyed_specs(specs)
    D, M = group.shape["data"], group.shape["model"]
    d, m = group.coords["data"], group.coords["model"]
    errors, shapes = {}, {}
    for T in ((16,) if case != "rwkv6" else (64, 12)):
        B = 8 if case == "moe" else 2
        x = (moe_input(cfg, B, T) if case == "moe" else torch.randn(
            B, T, cfg.d_model, generator=torch.Generator().manual_seed(3)))
        w = torch.randn(B, T, cfg.d_model,
                        generator=torch.Generator().manual_seed(5))
        n = B // D
        rows = slice(d * n, (d + 1) * n)

        # one process, whole leaves, the global loss
        ref = _grad_leaves(whole)
        xw = x.clone().requires_grad_(True)
        y_ref, s_ref = _layer(case, cfg, ref, xw)
        ref_grads = torch.autograd.grad(
            (y_ref * w).sum(), [xw] + tree_lib.leaves(ref))

        # this rank: its shards, its rows, its rows' loss
        mine = _grad_leaves(put_named(whole, stacked_specs, mesh, group))
        xm = x[rows].clone().requires_grad_(True)
        with ctx_lib.activation_sharding(("data",), "model", group=group,
                                         specs=keyed, batch=B):
            y, s = _layer(case, cfg, mine, xm)
            p = tf._layer_params(cfg, PREFIX, mine, 0)
        shapes[T] = {k: list(t.shape) for k, t in tree_lib.keyed(p).items()}
        grads = torch.autograd.grad((y * w[rows]).sum(),
                                    [xm] + tree_lib.leaves(mine))

        def err(name, got, want):
            errors[f"T{T}/{name}"] = [
                (got.detach() - want.detach()).abs().max().item(),
                want.detach().abs().max().item()]
        err("out", y, y_ref[rows])
        err("grad/x", grads[0], ref_grads[0][rows])
        cut = put_named(tree_lib.unflatten_like(ref, iter(ref_grads[1:])),
                        stacked_specs, mesh, group)
        for key, g, want in zip(tree_lib.keyed(mine), grads[1:],
                                tree_lib.leaves(cut)):
            err(f"grad/{key}", g, want)
        if s is not None:
            H = s[0].shape[1]
            err("state/ssm", s[0], s_ref[0][:, m * H:(m + 1) * H])
            c = s[1].shape[-1]
            err("state/conv", s[1], s_ref[1][..., m * c:(m + 1) * c])
    record = dict(errors=errors, shapes=shapes, mesh=[D, M])
    if case == "moe":
        record["drops"] = moe_drops(cfg, whole, moe_input(cfg, 8, 16))
    (out / f"rank{group.rank}.json").write_text(json.dumps(record))
