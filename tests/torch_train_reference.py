"""The reference's GSPMD train step in a subprocess, and the port's ranks
resumed from its step-0 checkpoint, for the tests that hold the port's
sharded and data-parallel train steps against it (reduced models in
float32 on the CPU, 3 steps of 4 x 16 tokens):

  * ``reference(out, arch, data, model, ...)`` runs ``REFERENCE`` on
    ``data x model`` forced host devices: ``repro.launch.steps.
    build_train_step`` at ``make_mesh_for(data=..., model=...)``, its
    params and moments placed by ``put_named`` of
    ``sanitize(param_specs(...))`` as ``repro.launch.train`` places them,
    ``SyntheticTokens`` with the launcher's AdamW settings, from
    ``PRNGKey(0)`` params that it also saves as a step-0 checkpoint
    (``out/ckpt``); the final state in ``out/ref``, each step's metrics
    returned. ``microbatches``: the step's accumulation factor;
    ``few_ids`` n > 0: every token and label id taken mod n (the routing
    piles up), and the assignments past capacity of the step-0 batch's
    routing, summed over the MoE layers, in ``out/drops.json``;
  * ``launcher(*argv)``: ``python -m repro_torch.launch.train`` (its
    output, and its step lines' metrics by step);
  * ``port(out, arch, data, model, ...)``: ``torch_sharding_ranks:run``
    (``launch.train.run`` in float32) on ``data x model`` gloo ranks,
    resumed from ``out/ckpt``, with the same options; returns each
    step's metrics of rank 0;
  * ``check(out, arch, got, want)``: ``close_trajectory`` of the metrics
    (loss, gradient norm and lr within 1e-5 relative) and
    ``close_trees`` of the final parameters and moments (1e-3 of each
    leaf's range), ``test_torch_train_step.py``'s bounds for one rank.
"""
import json
import os
import pathlib
import subprocess
import sys

from repro_torch import tree as tree_lib
from repro_torch.launch import dp
from test_torch_sharding import args_for, cfg_of, restore
from test_torch_train_step import close_trajectory, close_trees

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent
STEPS = 3

REFERENCE = '''
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.checkpoint import checkpoint as ck
from repro.compat import use_mesh
from repro.configs import get_arch
from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.launch import steps
from repro.launch.mesh import make_mesh_for
from repro.models import moe as jmoe
from repro.models import transformer as tf
from repro.models.sharding import param_specs, put_named, sanitize
from repro.optim import adamw
out, n, arch = sys.argv[1], int(sys.argv[2]), sys.argv[3]
D, M, micro, few = (int(a) for a in sys.argv[4:8])
spec = get_arch(arch)
cfg = dataclasses.replace(spec.reduced, dtype="float32")
spec = dataclasses.replace(spec, model=cfg)
ocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=min(20, n // 5),
                         total_steps=n, state_dtype="float32")
mesh = make_mesh_for(data=D, model=M)
params = tf.init_params(jax.random.PRNGKey(0), cfg)
opt = adamw.init_opt_state(params, ocfg)
ck.save(out + "/ckpt", 0, (params, opt))
data = SyntheticTokens(DataConfig(seq_len=16, global_batch=4,
                                  vocab_size=cfg.vocab_size))


def batch(s):
    b = data.host_batch(s)
    return {k: v % few for k, v in b.items()} if few else b


if few:
    plain, drops = jmoe.moe_ffn, []

    def counting(x, router_w, w_gate, w_up, w_down, top_k, **kw):
        N, E = x.shape[0], router_w.shape[-1]
        C = max(1, -(-int(N * top_k * 1.25) // E))
        C = -(-C // 8) * 8
        _, ids = jmoe.route_topk(x, router_w, top_k)
        counts = jnp.bincount(ids.reshape(-1), length=E)
        jax.debug.callback(lambda v: drops.append(int(v)),
                           jnp.maximum(counts - C, 0).sum())
        return plain(x, router_w, w_gate, w_up, w_down, top_k, **kw)
    jmoe.moe_ffn = counting
    tf.lm_loss(params, cfg, batch(0), remat=False).block_until_ready()
    jmoe.moe_ffn = plain
    json.dump(drops, open(out + "/drops.json", "w"))
with use_mesh(mesh):
    step, _, _ = steps.build_train_step(spec, "train_4k", mesh, ocfg,
                                        remat=True, microbatches=micro)
    p_specs = sanitize(param_specs(cfg, mesh), params, mesh)
    params = put_named(params, p_specs, mesh)
    opt = put_named(opt, adamw.OptState(step=P(), m=p_specs, v=p_specs),
                    mesh)
    logs = []
    for s in range(n):
        params, opt, m = step(params, opt, batch(s))
        logs.append({k: float(v) for k, v in m.items()})
ck.save(out + "/ref", n, (params, opt))
json.dump(logs, open(out + "/ref.json", "w"))
'''


def reference(out, arch="dec_s", data=2, model=2, microbatches=1, few_ids=0,
              steps=STEPS):
    """The reference's run (the module docstring): its metrics a step."""
    env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               XLA_FLAGS="--xla_force_host_platform_device_count="
               f"{data * model}",
               JAX_PLATFORMS="cpu", HOME=str(out))
    p = subprocess.run([sys.executable, "-c", REFERENCE, str(out), str(steps),
                        arch, str(data), str(model), str(microbatches),
                        str(few_ids)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads((pathlib.Path(out) / "ref.json").read_text())


def launcher(*args):
    """The port's launcher in a subprocess: (its output, each step's
    metrics by step)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(ROOT))
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout, {m["step"]: m for m in (
        json.loads(ln.split(" ", 3)[3]) for ln in p.stdout.splitlines()
        if ln.startswith("[train] step "))}


def port(out, arch, data, model, microbatches=1, few_ids=0, steps=STEPS,
         monkeypatch=None):
    """The port's ranks resumed from the reference's step-0 checkpoint:
    rank 0's metrics a step."""
    out = pathlib.Path(out)
    env = {"PYTHONPATH": os.pathsep.join(
        [str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "")
                        .split(os.pathsep) if p]), "OMP_NUM_THREADS": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    extra = ["--microbatches", str(microbatches), "--few-ids", str(few_ids)]
    (out / "port").mkdir()
    dp.launch(data * model, "torch_sharding_ranks:run",
              [str(out / "port")] + args_for(arch, out / "ckpt", steps,
                                             extra),
              device="cpu", timeout_s=300, model=model)
    record = json.loads((out / "port" / "rank0.json").read_text())
    return record["metrics"]


def _as_numpy(tree):
    return tree_lib.map(lambda t: t.numpy(), tree)


def check(out, arch, got, want, steps=STEPS):
    """The port's metrics and final state against the reference's."""
    out = pathlib.Path(out)
    assert [m["step"] for m in got] == list(range(steps))
    close_trajectory(got, want)
    cfg, ocfg = cfg_of(arch)
    mine = restore(out / "ckpt", cfg, ocfg, steps)
    ref = restore(out / "ref", cfg, ocfg, steps)
    close_trees(mine[0], _as_numpy(ref[0]))
    close_trees((mine[1].m, mine[1].v), _as_numpy((ref[1].m, ref[1].v)))
    assert int(mine[1].step) == int(ref[1].step) == steps
