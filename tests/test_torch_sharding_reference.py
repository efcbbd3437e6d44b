"""The sharded launcher against the reference's GSPMD step, and
checkpoints across mesh sizes (reduced Dec-S in float32 on the CPU):

  * the reference: a subprocess with 4 forced host devices runs
    ``repro.launch.steps.build_train_step`` at ``make_mesh_for(data=2,
    model=2)``, its params and moments placed by ``put_named`` of
    ``sanitize(param_specs(...))`` as ``repro.launch.train`` places
    them, for 3 steps of ``SyntheticTokens`` with the launcher's AdamW
    settings, from ``PRNGKey(0)`` params that it also saves as a step-0
    checkpoint. ``python -m repro_torch.launch.train --data 2 --model 2
    --dtype float32 --state-dtype float32`` resumes from that checkpoint
    on 4 gloo ranks and takes the same 3 steps: loss, gradient norm and
    lr within 1e-5 relative, and its step-3 checkpoint's parameters and
    moments within 1e-3 of each leaf's range of the reference's
    (``test_torch_train_step.py``'s bounds for one rank);
  * a 2 x 2 run checkpoints whole leaves at step 3 and goes on to step 4;
    from its step-3 checkpoint the launcher at 1 x 2 and one rank in this
    process (``elastic_restore``) each take step 4, both losses within
    1e-3 of the 2 x 2 run's (the reference's elastic bound).
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import torch

from repro_torch import tree as tree_lib
from repro_torch.launch import dp, train
from repro_torch.launch.steps import build_train_step
from repro_torch.runtime.fault_tolerance import elastic_restore
from test_torch_sharding import (args_for, cfg_of, restore, run_mesh)
from test_torch_train_step import close_trajectory, close_trees

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3

REFERENCE = '''
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.checkpoint import checkpoint as ck
from repro.compat import use_mesh
from repro.configs import get_arch
from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.launch import steps
from repro.launch.mesh import make_mesh_for
from repro.models import transformer as tf
from repro.models.sharding import param_specs, put_named, sanitize
from repro.optim import adamw
out, n = sys.argv[1], int(sys.argv[2])
spec = get_arch("dec_s")
cfg = dataclasses.replace(spec.reduced, dtype="float32")
spec = dataclasses.replace(spec, model=cfg)
ocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=min(20, n // 5),
                         total_steps=n, state_dtype="float32")
mesh = make_mesh_for(data=2, model=2)
params = tf.init_params(jax.random.PRNGKey(0), cfg)
opt = adamw.init_opt_state(params, ocfg)
ck.save(out + "/ckpt", 0, (params, opt))
data = SyntheticTokens(DataConfig(seq_len=16, global_batch=4,
                                  vocab_size=cfg.vocab_size))
with use_mesh(mesh):
    step, _, _ = steps.build_train_step(spec, "train_4k", mesh, ocfg,
                                        remat=True, microbatches=1)
    p_specs = sanitize(param_specs(cfg, mesh), params, mesh)
    params = put_named(params, p_specs, mesh)
    opt = put_named(opt, adamw.OptState(step=P(), m=p_specs, v=p_specs),
                    mesh)
    logs = []
    for s in range(n):
        params, opt, m = step(params, opt, data.host_batch(s))
        logs.append({k: float(v) for k, v in m.items()})
ck.save(out + "/ref", n, (params, opt))
json.dump(logs, open(out + "/ref.json", "w"))
'''


def launcher(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(ROOT))
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout, {m["step"]: m for m in (
        json.loads(ln.split(" ", 3)[3]) for ln in p.stdout.splitlines()
        if ln.startswith("[train] step "))}


def test_launcher_matches_the_reference_gspmd_step(tmp_path):
    env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", HOME=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp_path),
                        str(STEPS)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    ref_logs = json.loads((tmp_path / "ref.json").read_text())
    out, got = launcher(*args_for("dec_s", tmp_path / "ckpt", STEPS),
                        "--data", "2", "--model", "2")
    assert "mesh data 2 x model 2" in out
    assert sorted(got) == list(range(STEPS))
    close_trajectory([got[s] for s in range(STEPS)], ref_logs)
    cfg, ocfg = cfg_of("dec_s")
    mine = restore(tmp_path / "ckpt", cfg, ocfg, STEPS)
    ref = restore(tmp_path / "ref", cfg, ocfg, STEPS)
    close_trees(mine[0], _as_numpy(ref[0]))
    close_trees((mine[1].m, mine[1].v), _as_numpy((ref[1].m, ref[1].v)))
    assert int(mine[1].step) == int(ref[1].step) == STEPS


def _as_numpy(tree):
    return tree_lib.map(lambda t: t.numpy(), tree)


def test_two_by_two_checkpoint_resumes_on_smaller_meshes(tmp_path,
                                                         monkeypatch):
    ranks, out = run_mesh(tmp_path, monkeypatch, "dec_s", 2, 2,
                          extra=("--ckpt-every", "3"), steps=4)
    four = {m["step"]: m for m in ranks[0]["metrics"]}
    assert sorted(four) == [0, 1, 2, 3]
    # 1 x 2: the launcher resumes from the step-3 checkpoint
    two_dir = tmp_path / "two"
    two_dir.mkdir()
    shutil.copytree(out / "ckpt" / "step_00000003",
                    two_dir / "step_00000003")
    _, two = launcher(*args_for("dec_s", two_dir, 4), "--model", "2")
    assert sorted(two) == [3]
    assert abs(two[3]["loss"] - four[3]["loss"]) < 1e-3
    # 1 x 1: elastic_restore onto one rank in this process
    cfg, ocfg = cfg_of("dec_s")
    like = restore(out / "ckpt", cfg, ocfg, 3)
    (params, opt), step = elastic_restore(out / "ckpt", like,
                                          dp.Group.single("cpu"), step=3)
    assert step == 3 and int(opt.step) == 3
    _, _, data = train.setup(train.parser().parse_args(
        args_for("dec_s", "unused", 4)))
    batch = {k: torch.from_numpy(v) for k, v in data.host_batch(3).items()}
    _, _, m = build_train_step(cfg, ocfg)(params, opt, batch)
    assert abs(float(m["loss"]) - four[3]["loss"]) < 1e-3
