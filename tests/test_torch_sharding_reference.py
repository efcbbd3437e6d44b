"""The sharded launcher against the reference's GSPMD step, and
checkpoints across mesh sizes (reduced Dec-S in float32 on the CPU):

  * the reference (``torch_train_reference.reference``): a subprocess
    with 4 forced host devices runs ``repro.launch.steps.
    build_train_step`` at ``make_mesh_for(data=2, model=2)``, its params
    and moments placed by ``put_named`` of ``sanitize(param_specs(...))``
    as ``repro.launch.train`` places them, for 3 steps of
    ``SyntheticTokens`` with the launcher's AdamW settings, from
    ``PRNGKey(0)`` params that it also saves as a step-0 checkpoint.
    ``python -m repro_torch.launch.train --data 2 --model 2 --dtype
    float32 --state-dtype float32`` resumes from that checkpoint on 4
    gloo ranks and takes the same 3 steps: loss, gradient norm and lr
    within 1e-5 relative, and its step-3 checkpoint's parameters and
    moments within 1e-3 of each leaf's range of the reference's
    (``test_torch_train_step.py``'s bounds for one rank;
    ``torch_train_reference.check``);
  * a 2 x 2 run checkpoints whole leaves at step 3 and goes on to step 4;
    from its step-3 checkpoint the launcher at 1 x 2 and one rank in this
    process (``elastic_restore``) each take step 4, both losses within
    1e-3 of the 2 x 2 run's (the reference's elastic bound).
"""
import shutil

import torch

from repro_torch.launch import dp, train
from repro_torch.launch.steps import build_train_step
from repro_torch.runtime.fault_tolerance import elastic_restore
from test_torch_sharding import (args_for, cfg_of, restore, run_mesh)
from torch_train_reference import STEPS, check, launcher, reference


def test_launcher_matches_the_reference_gspmd_step(tmp_path):
    ref_logs = reference(tmp_path, "dec_s", 2, 2)
    out, got = launcher(*args_for("dec_s", tmp_path / "ckpt", STEPS),
                        "--data", "2", "--model", "2")
    assert "mesh data 2 x model 2" in out
    assert sorted(got) == list(range(STEPS))
    check(tmp_path, "dec_s", [got[s] for s in range(STEPS)], ref_logs)

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
