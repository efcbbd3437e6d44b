"""A run of the harness end to end at a test size (``testdata/``): the
port's engine on the CPU (its plain versions), the window, the
comparison. A sound run is correct; the timed path broken underneath (a
decode step that leaves the KV cache unchanged, a token altered where it
is emitted) is not; the precision control fails the cell's limits."""
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from ralm_bench import check, harness

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CHECKOUT = HERE / "testdata"      # laid out as a checkout of a tiny cell
SECONDS = 1.0


def cell():
    return harness.load_cell(CHECKOUT, "tiny.batch")


def run(seed, control=False, device="cpu"):
    return harness.run(cell(), seed, SECONDS, False, device,
                       time.perf_counter(), control=control)


def test_sound_run_is_correct():
    res = run(2 ** 31 + 101)
    assert res["checks"]["correct"], res["checks"]
    assert res["e2e"]["tokens_per_s"][0] > 0
    assert res["e2e"]["token_gap_p95_ms"][0] > 0
    assert res["e2e"]["ttft_p90_ms"][0] > 0


def test_traced_run_reads_the_host_and_leaves_the_program_as_it_was():
    import repro_torch.models.transformer as tf
    import repro_torch.retrieval.service as svc
    before = (tf.decode_attention, svc.fused_shard_scan)
    # the host-clock readers read the window before its traced tail
    seconds = harness.TRACE_SECONDS + SECONDS
    res = harness.run(cell(), 2 ** 31 + 105, seconds, True, "cpu",
                      time.perf_counter())
    assert res["checks"]["correct"], res["checks"]
    values = {n: v for n, (v, _) in res["per_layer"].items()}
    assert values["wave_ms"] > 0
    # no card: no device trace, so the rooflines read nothing
    assert values["fused_scan_roofline"] is None
    assert values["decode_attn_roofline"] is None
    assert (tf.decode_attention, svc.fused_shard_scan) == before


def test_kv_state_left_unchanged_is_not_correct(monkeypatch):
    import repro_torch.models.transformer as tf
    monkeypatch.setattr(tf, "update_cache", lambda k, v, *a, **kw: (k, v))
    assert not run(2 ** 31 + 102)["checks"]["correct"]


def test_token_altered_where_emitted_is_not_correct(monkeypatch):
    from repro_torch.serve.engine import RalmEngine
    emit = RalmEngine._emit

    def altered(self, seq, nxt):
        if seq.step == 2:
            nxt = (nxt + 1) % self.cfg.vocab_size
        return emit(self, seq, nxt)

    monkeypatch.setattr(RalmEngine, "_emit", altered)
    assert not run(2 ** 31 + 103)["checks"]["correct"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_precision_control_fails_the_limits(seed):
    checks = run(seed, control=True)["checks"]
    verdict = check.judge(checks["control_numbers"], cell().limits,
                          check.comparison(cell().config).NUMBERS)
    assert checks["correct"] and not verdict["correct"]
    assert checks["control_correct"] is False


def test_null_limit_leaves_a_number_out():
    names = {"a": "one", "b": "two"}
    verdict = check.judge({"a": 5.0, "b": 1.0}, {"a": None, "b": 2.0}, names)
    assert verdict["correct"] and list(verdict["numbers"]) == ["b"]
    assert not check.judge({"a": 5.0, "b": 1.0}, {"a": 4.0, "b": 2.0},
                           names)["correct"]


def test_command_line_prints_the_result_last():
    # a process of its own, as the driver's: its modules are the run's
    code = ("import pathlib, sys, time; from ralm_bench import harness; "
            "sys.exit(harness.main(sys.argv[2:], time.perf_counter(), "
            "pathlib.Path(sys.argv[1]), device='cpu'))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    proc = subprocess.run(
        [sys.executable, "-c", code, str(CHECKOUT), "--workload",
         "tiny.batch", "--seed", "5", "--seconds", str(SECONDS), "--trace",
         "0"], capture_output=True, text=True, timeout=120, env=env)
    out, err = proc.stdout, proc.stderr
    assert proc.returncode == 0, err[-2000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"tokens_per_s", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("[ralm_bench] correct =")


def test_no_result_once_jax_was_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    rc = harness.main(["--workload", "tiny.batch", "--seed", "6",
                       "--seconds", str(SECONDS), "--trace", "0"],
                      time.perf_counter(), CHECKOUT, device="cpu")
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == "" and "jaxlib" in err


def test_command_line_takes_only_the_drivers_options(capsys):
    with pytest.raises(SystemExit):
        harness.main(["--workload", "tiny.batch", "--seed", "5",
                      "--seconds", "1", "--trace", "0", "--device", "cpu"],
                     time.perf_counter(), CHECKOUT)


def test_no_result_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(harness.RunError):
        run(1, device="cuda")


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake.sub", sys)
    assert harness.forbidden_modules() == sorted(
        set(harness.forbidden_modules()))
    before = set(harness.forbidden_modules())
    assert "repro_torch_fake" not in before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


@pytest.mark.gpu
def test_sound_run_on_the_card():
    assert run(2 ** 31 + 104, device="cuda")["checks"]["correct"]
