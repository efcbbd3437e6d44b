"""The port's crash-safe training loop and its entry points on the CPU.

  * ``TrainController``: 12 steps straight against a run that crashes
    after step 8 (``SimulatedFailure``) and resumes from its checkpoint
    with fresh parameters, which must be ignored: every step's loss
    equal, bit for bit. The straight run's 12 losses against the JAX
    ``TrainController``'s on the same setup (reduced Dec-S in bfloat16,
    float32 Adam states, the reference's ``tests/test_fault_tolerance.py``
    set-up): within 2^-8 relative, the bf16 rounding of two packages
    carried through 12 updates.
  * The launcher: ``--device cpu --reduced`` trains and prints the
    reference's summary line and one JSON line per step; without CUDA
    and without ``--device cpu`` it refuses; ``--data 1 --model 2``
    trains on two sharded ranks, every loss finite and within 1e-3 of
    the one-rank run's.
  * ``python -m repro_torch.examples.train_retro --device cpu``: the
    reduced EncDec-S learns from its label-correlated chunk embeddings
    (the loss falls; the example raises otherwise).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.runtime.fault_tolerance import TrainController as JaxController
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (SimulatedFailure,
                                                 TrainController)

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50, state_dtype="float32")


def make_setup(ckpt_dir):
    cfg = get_arch("dec_s").reduced
    ocfg = adamw.AdamWConfig(**OPT)
    data = SyntheticTokens(DataConfig(seq_len=16, global_batch=4,
                                      vocab_size=cfg.vocab_size))
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw.init_opt_state(params, ocfg)
    ctl = TrainController(build_train_step(cfg, ocfg, remat=False), data,
                          ckpt_dir, ckpt_every=4)
    return params, opt, ctl


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    p, o, ctl = make_setup(tmp_path_factory.mktemp("a"))
    ctl.run(p, o, total_steps=12)
    return [m["loss"] for m in ctl.metrics_log]


def test_crash_resume_identical_trajectory(tmp_path, straight):
    p, o, ctl = make_setup(tmp_path / "b")
    ctl.fail_at = 8
    with pytest.raises(SimulatedFailure):
        ctl.run(p, o, total_steps=12)
    assert sorted(d.name for d in (tmp_path / "b").iterdir()) == \
        ["step_00000004", "step_00000008"]
    p2, o2, _ = make_setup(tmp_path / "ignored")
    ctl.run(p2, o2, total_steps=12)
    resumed = {m["step"]: m["loss"] for m in ctl.metrics_log}
    assert sorted(resumed) == list(range(12))
    assert [resumed[s] for s in range(12)] == straight
    assert straight[-1] < straight[0]


def test_losses_follow_the_reference_controller(tmp_path):
    cfg = jax_arch("dec_s").reduced
    ocfg = jadamw.AdamWConfig(**OPT)

    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jtf.lm_loss(p, cfg, batch, remat=False))(params)
        params, opt_state, m = jadamw.apply_updates(params, grads,
                                                    opt_state, ocfg)
        m["loss"] = loss
        return params, opt_state, m

    data = JaxTokens(JaxDataConfig(seq_len=16, global_batch=4,
                                   vocab_size=cfg.vocab_size))
    jp = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.lm_params(jax.tree.map(
        lambda x: np.array(x.astype(jnp.float32)), jp),
        convert.model_config(dataclasses.asdict(cfg)))
    ctl = JaxController(jax.jit(train_step), data, tmp_path / "jax",
                        ckpt_every=4)
    ctl.run(jp, jadamw.init_opt_state(jp, ocfg), total_steps=12)
    want = [m["loss"] for m in ctl.metrics_log]
    port_cfg = get_arch("dec_s").reduced
    p_ctl = TrainController(build_train_step(port_cfg, adamw.AdamWConfig(
        **OPT), remat=False), SyntheticTokens(DataConfig(
            seq_len=16, global_batch=4, vocab_size=port_cfg.vocab_size)),
        tmp_path / "port", ckpt_every=4)
    p_ctl.run(tp, adamw.init_opt_state(tp, adamw.AdamWConfig(**OPT)),
              total_steps=12)
    got = [m["loss"] for m in p_ctl.metrics_log]
    np.testing.assert_allclose(got, want, rtol=2 ** -8)


def _run(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env.update(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=str(ROOT))


def test_launcher_trains_on_the_cpu_and_refuses_otherwise(tmp_path):
    ok = _run(["repro_torch.launch.train", "--arch", "dec_s", "--reduced",
               "--steps", "6", "--seq-len", "16", "--device", "cpu",
               "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"])
    assert ok.returncode == 0, ok.stdout + ok.stderr
    steps = [json.loads(ln.split(" ", 3)[3]) for ln in ok.stdout.splitlines()
             if ln.startswith("[train] step ")]
    assert [m["step"] for m in steps] == list(range(6))
    assert all(np.isfinite(m["loss"]) for m in steps)
    assert "[train] dec_s: step0 loss" in ok.stdout
    assert "over 6 steps" in ok.stdout
    assert sorted(d.name for d in (tmp_path / "ck").iterdir()) == \
        ["step_00000003", "step_00000006"]
    gpu = _run(["repro_torch.launch.train", "--arch", "dec_s", "--reduced",
                "--steps", "1"])
    assert gpu.returncode != 0 and "GPU" in gpu.stderr
    assert "[train]" not in gpu.stdout
    tp = _run(["repro_torch.launch.train", "--arch", "dec_s", "--reduced",
               "--steps", "6", "--seq-len", "16", "--device", "cpu",
               "--data", "1", "--model", "2",
               "--ckpt-dir", str(tmp_path / "tp"), "--ckpt-every", "3"])
    assert tp.returncode == 0, tp.stdout + tp.stderr
    assert "mesh data 1 x model 2" in tp.stdout
    sharded = [json.loads(ln.split(" ", 3)[3])
               for ln in tp.stdout.splitlines()
               if ln.startswith("[train] step ")]
    assert [m["step"] for m in sharded] == list(range(6))
    for m, one in zip(sharded, steps):
        assert np.isfinite(m["loss"]) and abs(m["loss"] - one["loss"]) < 1e-3


def test_train_retro_example_learns_on_the_cpu(tmp_path):
    p = _run(["repro_torch.examples.train_retro", "--device", "cpu",
              "--steps", "20", "--ckpt-dir", str(tmp_path)])
    assert p.returncode == 0, p.stdout + p.stderr
    assert "encdec-s" in p.stdout and "loss:" in p.stdout
    assert (tmp_path / "step_00000020" / "manifest.json").exists()
