"""The dry run (twin of ``repro.launch.dryrun``): every registered model
at full width, at the reference's ``SHAPES``, on the reference's
production meshes, without a device.

    python -m repro_torch.launch.dryrun [--arch all|NAME] [--shape all|NAME]
        [--mesh single|multi|both] [--no-retrieval] [--paper-archs]
        [--out FILE] [--force] [--table]

``--table`` runs nothing: it prints the records already under
``build/dryrun/`` for the chosen models and shapes as one markdown table
(a row per model x shape, both meshes side by side).

The reference lowers and compiles each cell's jitted step for a 256- or
512-chip TPU mesh and reads XLA's cost and memory analyses. Here each
cell's step (``launch.steps``: train, prefill, or the retrieval-augmented
serve step) runs eagerly on meta tensors, which carry shapes and dtypes
and no storage, under the cost counter (``launch.analysis``). Nothing is
allocated, and CUDA is not initialised.

A record per cell goes to ``build/dryrun/dryrun_<arch>_<shape>_<mesh>.json``
with the reference's keys (``dryrun.py:96-117``):

  * the whole step's FLOPs and bytes come from the meta run, and the
    per-device values are their even split over the mesh's positions
    (``"per_dev_rule": "even split"``): the port has no SPMD program to
    read a per-device count from;
  * ``arg_bytes_per_dev`` is exact: the sum, over the step's arguments
    (params, optimizer state and batch for train; params, caches and
    batch for prefill and decode; plus the database's quantizers and
    shards, the payload table and the query projection when retrieving),
    of each argument's per-device shard (``sharding.shard_shape`` under
    its sanitised spec); ``out_bytes_per_dev`` likewise for the step's
    outputs;
  * ``lower_s`` is the seconds of the meta run, the counterpart of the
    reference's lowering;
  * quantities the port cannot have are null: ``compile_s``,
    ``temp_bytes_per_dev`` (XLA's buffer assignment), ``xla_cost_flops``
    and ``xla_cost_bytes`` (XLA's own cost analysis), and the
    collectives (``collective_bytes_per_dev``, ``collectives``,
    ``collective_s``), which need an SPMD program over several devices
    (ROADMAP Queue 1 item 20);
  * ``dominant`` and ``roofline_fraction`` are null too: the bytes are
    those of the plain, eager versions (the fused scan's plain version
    gathers every probed list, every intermediate is written and read
    back), an upper bound that would make ``memory_s`` the larger term
    by construction rather than by what a deployment runs.
    ``compute_s`` and ``memory_s`` stay.

One meta run serves every mesh whose global program is the same: the
mesh changes no shape of the model's program, but the train step's
micro-batches and the decode step's database stack (one shard per
data-parallel position) follow it, so those are part of the run's key.
A run counts whole layers only as far as it must: a stack of ``L``
layers whose ``layer_pattern`` has period ``p`` (``L = q p + r``) is
run at depths ``p``, ``2 p`` and ``p + r``, and the count is
``c(p) + (q - 1) (c(2p) - c(p)) + c(p + r) - c(p)``, exact because every
layer of a class costs the same; a stack shorter than those runs
together runs whole.

A skip-listed shape gives ``SKIP`` with its reason, and a cell that
raises is recorded as ``FAIL`` with its traceback.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import SHAPES, ArchSpec, get_arch, list_archs
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.analysis import (HBM_BW, PEAK_FLOPS, Cost,
                                         count_cost, roofline_terms)
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.sharding import (P, dp_axes, param_specs, sanitize,
                                         shard_shape, spec_leaves)
from repro_torch.optim import adamw

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
H100_BYTES = 80e9            # one H100's device memory

# (arch, shape, program key) -> (Cost, seconds, depths run)
_COSTS: Dict[Tuple, Tuple[Cost, float, Tuple[int, ...]]] = {}


def _with_depth(spec: ArchSpec, n_layers: int) -> ArchSpec:
    return dataclasses.replace(
        spec, model=dataclasses.replace(spec.model, n_layers=n_layers))


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh)) or 1


def _run_step(spec: ArchSpec, shape: str, kind: str, micro: int,
              n_shards: int, with_retrieval: bool) -> Cost:
    """Count one step of ``spec`` at ``shape`` on meta tensors."""
    cfg = spec.model
    params = steps_lib.abstract_params(cfg)
    if kind == "train":
        opt = adamw.init_opt_state(params, adamw.AdamWConfig())
        step = steps_lib.build_train_step(cfg, microbatches=micro)
        args = (params, opt, specs_lib.train_batch_struct(spec, shape))
    elif kind == "prefill":
        step, _ = steps_lib.build_prefill_step(spec, shape, _one_position())
        args = (params, specs_lib.cache_struct(spec, shape),
                specs_lib.prefill_struct(spec, shape))
    else:
        step, _, (ccfg, structs) = steps_lib.build_serve_step(
            spec, shape, _one_position(), with_retrieval=with_retrieval)
        args = (params, structs["cache"], structs["batch"])
        if with_retrieval:
            _, db_shard = specs_lib.db_struct(
                specs_lib.ServeDBSpec().for_model(cfg, n_shards,
                                                  spec.rag.k), n_shards)
            args += (structs["db_params"], db_shard, structs["payload"])
            if "proj" in structs:
                args += (structs["proj"],)
    return count_cost(step, *args)[1]


def _one_position() -> Mesh:
    return Mesh(("data", "model"), (1, 1), ("meta",))


def step_cost(spec: ArchSpec, shape: str, micro: int = 1, n_shards: int = 1,
              with_retrieval: bool = True
              ) -> Tuple[Cost, float, Tuple[int, ...]]:
    """(the whole step's Cost, the seconds it took to count, the depths
    run) for one global program, memoised."""
    kind = SHAPES[shape]["kind"]
    key = (spec.name, shape, kind, micro if kind == "train" else None,
           n_shards if kind == "decode" and with_retrieval else None,
           with_retrieval and kind == "decode")
    if key in _COSTS:
        return _COSTS[key]
    t0 = time.perf_counter()
    L = spec.model.n_layers
    p = len(spec.model.layer_pattern)
    q, r = divmod(L, p)
    run = lambda n: _run_step(_with_depth(spec, n), shape, kind, micro,
                              n_shards, with_retrieval)
    if q < 2 or 3 * p + (p + r if r else 0) >= L:
        cost, depths = run(L), (L,)
    else:
        c1, c2 = run(p), run(2 * p)
        cost = c1 + (c2 - c1).scaled(q - 1)
        depths = (p, 2 * p)
        if r:
            cost = cost + (run(p + r) - c1)
            depths += (p + r,)
    _COSTS[key] = (cost, time.perf_counter() - t0, depths)
    return _COSTS[key]


def _bytes_per_dev(structs, spec_tree, mesh) -> int:
    """Sum of each leaf's per-device shard bytes under its spec."""
    specs = sanitize(spec_tree, structs, mesh)
    flat_specs = spec_leaves(specs)
    leaves = tree_lib.leaves(structs)
    if len(flat_specs) != len(leaves):
        raise ValueError(f"{len(flat_specs)} specs for {len(leaves)} leaves")
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, flat_specs))


def state_bytes_per_dev(cfg, mesh, opt_cfg=None) -> Tuple[int, int]:
    """(parameter bytes, optimiser-state bytes) that one device holds in
    a training step over ``mesh``: a train cell's ``arg_bytes_per_dev``
    without the batch."""
    p_struct = steps_lib.abstract_params(cfg)
    p_specs = param_specs(cfg, mesh, p_struct)
    opt = adamw.init_opt_state(p_struct, opt_cfg or adamw.AdamWConfig())
    opt_specs = adamw.OptState(step=P(), m=p_specs, v=p_specs)
    return (_bytes_per_dev(p_struct, p_specs, mesh),
            _bytes_per_dev(opt, opt_specs, mesh))


def _arg_out_bytes(spec: ArchSpec, shape: str, kind: str, mesh,
                   with_retrieval: bool) -> Tuple[int, int, int]:
    """(argument bytes per device, output bytes per device, argument
    bytes in all) of the cell's step."""
    cfg = spec.model
    sh = SHAPES[shape]
    B, V = sh["global_batch"], cfg.vocab_size
    dp = dp_axes(mesh)
    if kind == "train":
        p_struct = steps_lib.abstract_params(cfg)
        p_specs = param_specs(cfg, mesh, p_struct)
        opt = adamw.init_opt_state(p_struct, adamw.AdamWConfig())
        opt_specs = adamw.OptState(step=P(), m=p_specs, v=p_specs)
        batch = specs_lib.train_batch_struct(spec, shape)
        b_specs = specs_lib.train_batch_specs(spec, shape, mesh)
        parts = [(p_struct, p_specs), (opt, opt_specs), (batch, b_specs)]
        outs = parts[:2]
    elif kind == "prefill":
        _, (p_specs, c_specs, b_specs) = steps_lib.build_prefill_step(
            spec, shape, mesh)
        caches = specs_lib.cache_struct(spec, shape)
        parts = [(steps_lib.abstract_params(cfg), p_specs),
                 (caches, c_specs),
                 (specs_lib.prefill_struct(spec, shape), b_specs)]
        logits = specs_lib.S((B, V), cfg.torch_dtype)
        outs = [(logits, P(dp, "model")), (caches, c_specs)]
    else:
        _, shardings, (_, structs) = steps_lib.build_serve_step(
            spec, shape, mesh, with_retrieval=with_retrieval)
        parts = [(steps_lib.abstract_params(cfg), shardings["params"]),
                 (structs["cache"], shardings["caches"]),
                 (structs["batch"], shardings["batch"])]
        for name in ("db_params", "db_shard", "payload", "proj"):
            if name in structs:
                parts.append((structs[name], shardings[name]))
        logits = specs_lib.S((B, V), torch.float32 if with_retrieval
                             else cfg.torch_dtype)
        outs = [(logits, P(dp if B >= 8 else None, "model")),
                (structs["cache"], shardings["caches"])]
    arg = sum(_bytes_per_dev(s, t, mesh) for s, t in parts)
    out = sum(_bytes_per_dev(s, t, mesh) for s, t in outs)
    total = sum(t.numel() * t.element_size()
                for s, _ in parts for t in tree_lib.leaves(s))
    return arg, out, total


def run_cell(arch: str, shape: str, multi_pod: bool,
             with_retrieval: bool = True) -> dict:
    """Count one (arch x shape x mesh) cell on meta tensors; its record."""
    spec = get_arch(arch)
    mesh_name = "multi" if multi_pod else "single"
    if shape in spec.skip_shapes:
        return dict(arch=arch, shape=shape, mesh=mesh_name, status="SKIP",
                    reason=spec.skip_shapes[shape])
    t_cell = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = spec.model
    kind = SHAPES[shape]["kind"]
    retrieval = bool(with_retrieval and kind == "decode")
    micro = steps_lib.default_microbatches(spec, shape, _dp_size(mesh))
    n_shards = specs_lib.num_db_shards(mesh)
    cost, lower_s, depths = step_cost(spec, shape, micro, n_shards,
                                      with_retrieval)
    arg, out, arg_total = _arg_out_bytes(spec, shape, kind, mesh,
                                         with_retrieval)
    n_dev = mesh.size
    per_dev = cost.scaled(1.0 / n_dev)
    terms = roofline_terms(per_dev)
    # MODEL_FLOPS: 6 N D for train (fwd + bwd), 2 N D for inference, N
    # the active params, D the tokens this step processes
    n_active = cfg.active_param_count()
    sh = SHAPES[shape]
    if kind == "train":
        model_flops = 6.0 * n_active * sh["global_batch"] * sh["seq_len"]
    elif kind == "prefill":
        model_flops = 2.0 * n_active * sh["global_batch"] * sh["seq_len"]
    else:
        model_flops = 2.0 * n_active * sh["global_batch"]
    return dict(
        arch=arch, shape=shape, mesh=mesh_name, status="OK", kind=kind,
        n_devices=int(n_dev), retrieval=retrieval,
        lower_s=round(lower_s, 1), compile_s=None,
        hlo_flops_per_dev=per_dev.flops, hlo_bytes_per_dev=per_dev.bytes,
        collective_bytes_per_dev=None, collectives=None,
        compute_s=terms["compute_s"], memory_s=terms["memory_s"],
        collective_s=terms["collective_s"], dominant=None,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / n_dev / per_dev.flops
                            if per_dev.flops else 0.0),
        roofline_fraction=None,
        arg_bytes_per_dev=arg, temp_bytes_per_dev=None,
        out_bytes_per_dev=out, xla_cost_flops=None, xla_cost_bytes=None,
        per_dev_rule="even split", step_flops=cost.flops,
        step_bytes=cost.bytes, arg_bytes_total=arg_total,
        args_fit_one_h100_per_dev=arg <= H100_BYTES,
        microbatches=micro if kind == "train" else None,
        depths_run=list(depths), seconds=round(time.perf_counter() - t_cell,
                                               1),
        peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW)


def table(archs, shapes) -> str:
    """A markdown row per (arch, shape) from the saved records: status,
    the meta run's seconds (this host's CPU), the whole step's TFLOPs
    and GB, arguments per device on each mesh, and whether they fit one
    H100's 80 GB."""
    rows = ["| model | shape | status | meta run s | step TFLOP | step GB "
            "(eager, upper bound) | args GB/dev 16x16 | args GB/dev "
            "2x16x16 | args fit 80 GB/dev (16x16, 2x16x16) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in archs:
        for shape in shapes:
            recs = {}
            for m in ("single", "multi"):
                f = RESULTS / f"dryrun_{arch}_{shape}_{m}.json"
                recs[m] = json.loads(f.read_text()) if f.exists() else None
            one, two = recs["single"], recs["multi"]
            if one is None or two is None:
                rows.append(f"| {arch} | {shape} | not run | | | | | | |")
                continue
            status = one["status"] if one["status"] == two["status"] \
                else f"{one['status']} / {two['status']}"
            if status == "SKIP":
                rows.append(f"| {arch} | {shape} | SKIP | | | | | | |")
                continue
            if status != "OK":
                why = (one.get("error") or two.get("error") or "?")
                rows.append(f"| {arch} | {shape} | {status}: "
                            f"{why.splitlines()[-1][:80]} | | | | | | |")
                continue
            secs = (f"{one['lower_s']}" if one["lower_s"] == two["lower_s"]
                    else f"{one['lower_s']} / {two['lower_s']}")
            rows.append(
                f"| {arch} | {shape} | OK | {secs} | "
                f"{one['step_flops'] / 1e12:.4g} | "
                f"{one['step_bytes'] / 1e9:.4g} | "
                f"{one['arg_bytes_per_dev'] / 1e9:.3f} | "
                f"{two['arg_bytes_per_dev'] / 1e9:.3f} | "
                f"{'yes' if one['args_fit_one_h100_per_dev'] else 'no'}, "
                f"{'yes' if two['args_fit_one_h100_per_dev'] else 'no'} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser(description="meta-tensor dry run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-retrieval", action="store_true")
    ap.add_argument("--paper-archs", action="store_true",
                    help="also run the paper's Table-2 RALM configs")
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the saved records as a markdown table")
    args = ap.parse_args()

    archs = (list_archs(include_paper=args.paper_archs)
             if args.arch == "all" else [args.arch])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.table:
        print(table(archs, shapes))
        return

    RESULTS.mkdir(parents=True, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for m in meshes:
                out = pathlib.Path(args.out) if args.out else (
                    RESULTS / f"dryrun_{arch}_{shape}_{m}.json")
                if out.exists() and not args.force:
                    print(f"[skip-cached] {arch} {shape} {m}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {m} ...", flush=True)
                t0 = time.perf_counter()
                try:
                    rec = run_cell(arch, shape, multi_pod=(m == "multi"),
                                   with_retrieval=not args.no_retrieval)
                except Exception as e:  # a failing cell is a finding
                    rec = dict(arch=arch, shape=shape, mesh=m,
                               status="FAIL", error=str(e)[-2000:],
                               tb=traceback.format_exc()[-4000:],
                               seconds=round(time.perf_counter() - t0, 1))
                out.write_text(json.dumps(rec, indent=1))
                status = rec["status"]
                if status == "OK":
                    print(f"  OK {rec['seconds']}s (meta run "
                          f"{rec['lower_s']}s) "
                          f"flops/dev={rec['hlo_flops_per_dev']:.3e} "
                          f"bytes/dev={rec['hlo_bytes_per_dev']:.3e} "
                          f"args/dev={rec['arg_bytes_per_dev']:.3e}",
                          flush=True)
                else:
                    print(f"  {status}: "
                          f"{rec.get('reason', rec.get('error', ''))[:300]}",
                          flush=True)


if __name__ == "__main__":
    main()
