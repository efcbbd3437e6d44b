"""Data-parallel training ranks on the CPU (gloo), each a process of its
own started by ``launch.dp`` (the twins of ``tests/test_distributed.py``'s
``compressed_psum_and_dp_training`` and
``elastic_resume_across_mesh_sizes``):

  * the launcher with ``--data 2``: each step's loss within 1e-3 of a
    one-rank run of the same global batch (the reference's elastic
    bound; the two sum in different orders);
  * 4 ranks train 3 steps and checkpoint, then go on to step 4; from the
    step-3 checkpoint 2 ranks (the launcher's resume) and one rank in
    this process (``elastic_restore``) each take step 4: both losses
    within 1e-3 of the 4-rank step 4;
  * ``compressed_all_reduce`` over 8 ranks: within 0.05 of the exact sum
    (relative to its largest entry) with stochastic rounding and with
    rounding to nearest, and with rounding to nearest bit-equal to the
    reference's ``compressed_psum`` over 8 devices, run as
    ``tests/test_distributed.py`` runs it.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from repro_torch.launch import dp, train
from repro_torch.launch.steps import build_train_step
from repro_torch.runtime.fault_tolerance import elastic_restore

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "dec_s", "--reduced", "--seq-len", "16", "--batch", "8",
        "--device", "cpu"]


def launcher(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *ARGS, *args], capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(ROOT))
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout, {m["step"]: m for m in (
        json.loads(ln.split(" ", 3)[3]) for ln in p.stdout.splitlines()
        if ln.startswith("[train] step "))}


def one_rank(argv):
    """The launcher's run on one rank, in this process."""
    ctl = train.run(dp.Group.single("cpu"), ARGS + argv)
    return {m["step"]: m for m in ctl.metrics_log}


def test_two_ranks_follow_one(tmp_path):
    out, two = launcher("--data", "2", "--steps", "3",
                        "--ckpt-dir", str(tmp_path / "two"))
    assert "[dp] 2 ranks on cpu, backend gloo" in out
    one = one_rank(["--steps", "3", "--ckpt-dir", str(tmp_path / "one")])
    assert sorted(two) == sorted(one) == [0, 1, 2]
    for s in range(3):
        assert abs(two[s]["loss"] - one[s]["loss"]) < 1e-3, s
        assert two[s]["allreduce_bytes"] > 0
    assert "allreduce_ms" not in one[0]


def test_elastic_resume_from_four_ranks(tmp_path):
    four_dir, two_dir = tmp_path / "four", tmp_path / "two"
    _, four = launcher("--data", "4", "--steps", "4", "--ckpt-every", "3",
                       "--ckpt-dir", str(four_dir))
    assert sorted(four) == [0, 1, 2, 3]
    two_dir.mkdir()
    shutil.copytree(four_dir / "step_00000003", two_dir / "step_00000003")
    _, two = launcher("--data", "2", "--steps", "4", "--ckpt-dir",
                      str(two_dir))
    assert sorted(two) == [3]
    assert abs(two[3]["loss"] - four[3]["loss"]) < 1e-3

    args = train.parser().parse_args(ARGS + ["--steps", "4"])
    cfg, ocfg, params, opt, data = train.build(args, "cpu")
    (params, opt), step = elastic_restore(four_dir, (params, opt),
                                          dp.Group.single("cpu"), step=3)
    assert step == 3 and int(opt.step) == 3
    batch = {k: torch.from_numpy(v) for k, v in data.host_batch(3).items()}
    _, _, m = build_train_step(cfg, ocfg)(params, opt, batch)
    assert abs(float(m["loss"]) - four[3]["loss"]) < 1e-3


RANK_ENTRY = '''
import numpy as np, torch
from repro_torch.optim.compression import compressed_all_reduce

def run(group, argv):
    x = torch.from_numpy(np.load(argv[0]))[group.rank].clone()
    exact = group.all_reduce(x.clone(), "sum")
    near = compressed_all_reduce({"w": x}, group)["w"]
    gen = torch.Generator().manual_seed(group.rank)
    stoch = compressed_all_reduce({"w": x}, group, gen)["w"]
    if group.rank == 0:
        np.save(argv[1], torch.stack([exact, near, stoch]).numpy())
'''

JAX_PSUM = '''
import sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map, use_mesh
from repro.optim.compression import compressed_psum
mesh = make_mesh((8,), ("data",))
x = jnp.asarray(np.load(sys.argv[1]))
def body(xs):
    return compressed_psum({"w": xs[0]}, "data")["w"]
f = shard_map(body, mesh=mesh, in_specs=(P("data"),), out_specs=P(),
              check_vma=False)
with use_mesh(mesh):
    np.save(sys.argv[2], np.asarray(jax.jit(f)(x)))
'''


def test_compressed_all_reduce_over_eight_ranks(tmp_path, monkeypatch):
    x = np.asarray(torch.randn(8, 256, generator=torch.Generator()
                               .manual_seed(0)).numpy())
    np.save(tmp_path / "x.npy", x)
    (tmp_path / "cpsum_rank.py").write_text(RANK_ENTRY)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    dp.launch(8, "cpsum_rank:run", [str(tmp_path / "x.npy"),
                                    str(tmp_path / "out.npy")],
              device="cpu", timeout_s=300)
    exact, near, stoch = np.load(tmp_path / "out.npy")
    np.testing.assert_allclose(exact, x.sum(0), rtol=1e-5, atol=1e-5)
    for got in (near, stoch):
        assert np.abs(got - exact).max() / np.abs(exact).max() < 0.05
    assert not np.array_equal(near, stoch)
    env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               HOME=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", JAX_PSUM,
                        str(tmp_path / "x.npy"), str(tmp_path / "ref.npy")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    np.testing.assert_array_equal(near, np.load(tmp_path / "ref.npy"))
