"""Package rules of the port, each checked in a fresh subprocess:

  * importing every ``repro_torch`` module (the training modules, the
    dry run and the shims included) and ``chip_smoke.py`` leaves ``jax``
    and ``repro`` out of ``sys.modules``;
  * ``RalmEngine.from_config`` without a device raises when CUDA is
    absent, and ``chip_smoke.py`` exits non-zero without printing a
    result (also when it stands alone, outside the repository);
  * the launcher (``python -m repro_torch.launch.serve``) refuses to run
    without CUDA unless given ``--device cpu``, and runs with it (also
    disaggregated, its memory nodes on the CPU);
  * a kernel wrapper handed CPU tensors runs the plain version, builds
    nothing and launches nothing, with no ``nvcc`` in reach.
"""
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(code: str, cwd=ROOT, args=None):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env.update(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable] + (args if args is not None else ["-c", code])
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(cwd))


def test_port_imports_neither_jax_nor_repro():
    p = _run("""
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 30, names
assert {"repro_torch.launch.serve", "repro_torch.serve.gateway.server",
        "repro_torch.serve.gateway.admission",
        "repro_torch.serve.gateway.degrade", "repro_torch.launch.mesh",
        "repro_torch.retrieval.fabric",
        "repro_torch.retrieval.router", "repro_torch.models.moe",
        "repro_torch.models.ssm", "repro_torch.launch.train",
        "repro_torch.launch.steps", "repro_torch.launch.dp",
        "repro_torch.optim.adamw", "repro_torch.optim.compression",
        "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpoint",
        "repro_torch.examples.train_retro", "repro_torch.tree",
        "repro_torch.runtime.procs", "repro_torch.launch.dryrun",
        "repro_torch.launch.analysis", "repro_torch.launch.specs",
        "repro_torch.models.sharding", "repro_torch.core.generate",
        "repro_torch.core.coordinator",
        "repro_torch.examples.quickstart", "repro_torch.models.ctx",
        "repro_torch.models.parallel"} <= set(names), names
""")
    assert p.returncode == 0, p.stdout + p.stderr


def test_entry_points_refuse_to_run_without_cuda(tmp_path):
    p = _run("""
import pytest, torch
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tf
from repro_torch.serve import (DatastoreBuilder, EngineConfig, RalmEngine)
arch = get_arch("dec_s")
params = tf.init_params(torch.Generator().manual_seed(0), arch.reduced)
ds = DatastoreBuilder(dim=64, nlist=4, m=8, device="cpu").build(
    torch.randn(300, 64))
with pytest.raises(RuntimeError, match="GPU"):
    RalmEngine.from_config(EngineConfig(arch.reduced, arch.rag), params, ds,
                           ds.search_config(nprobe=2, k=4))
with pytest.raises(RuntimeError, match="GPU"):
    DatastoreBuilder(dim=64).build(torch.randn(300, 64))
RalmEngine.from_config(EngineConfig(arch.reduced, arch.rag), params, ds,
                       ds.search_config(nprobe=2, k=4), device="cpu")
""")
    assert p.returncode == 0, p.stdout + p.stderr
    smoke = _run("", args=["chip_smoke.py"])
    assert smoke.returncode != 0 and '"ok"' not in smoke.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run("", cwd=tmp_path, args=["chip_smoke.py"])
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


def test_launcher_refuses_to_run_without_cuda():
    for extra in ([], ["--gateway", "--port", "0"], ["--per-sequence"],
                  ["--disaggregate"]):
        p = _run("", args=["-m", "repro_torch.launch.serve", "--reduced",
                           *extra])
        assert p.returncode != 0 and "GPU" in p.stderr, p.stderr
        assert "[serve]" not in p.stdout
    ok = _run("", args=["-m", "repro_torch.launch.serve", "--device", "cpu",
                        "--reduced", "--steps", "2", "--per-sequence",
                        "--async-retrieval"])
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "[serve] per-sequence: 2 batches, 8 tokens" in ok.stdout
    split = _run("", args=["-m", "repro_torch.launch.serve", "--device",
                           "cpu", "--reduced", "--steps", "2",
                           "--disaggregate"])
    assert split.returncode == 0, split.stdout + split.stderr
    assert "[serve] wave: 2 batches, 8 tokens" in split.stdout
    assert "2 memory nodes" in split.stdout


def test_cpu_tensors_take_the_plain_versions_without_nvcc():
    p = _run("""
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.chamvs_scan import ops as cs
from repro_torch.kernels.decode_attn import ops as da
from repro_torch.kernels.ivf_scan import ops as iv
from repro_torch.kernels.pq_adc import ops as pq
from repro_torch.kernels.topk import ops as tk
g = torch.Generator().manual_seed(0)
q = torch.randn(3, 1, 4, 8, generator=g).bfloat16()
k = torch.randn(5, 16, 2, 8, generator=g).bfloat16()
slots, pos = torch.tensor([4, 0, 2]), torch.tensor([3, 15, 9])
out = da.decode_attention(q, k, k, pos, slots=slots, kv_len=16)
ref = da.ref_decode_attention(q, k[slots.long()], k[slots.long()], pos)
assert torch.equal(out, ref)
qs, cents = torch.randn(4, 8, generator=g), torch.randn(10, 8, generator=g)
assert all(torch.equal(a, b) for a, b in zip(
    iv.ivf_index_scan(qs, cents, 3), iv.ref_ivf_scan(qs, cents, 3)))
luts = torch.rand(4, 3, 2, 16, generator=g)
codes = torch.randint(0, 16, (2, 10, 6, 2), generator=g).to(torch.uint8)
ids = torch.arange(120, dtype=torch.int32).view(2, 10, 6)
lens = torch.randint(0, 7, (2, 10), generator=g).int()
probe = iv.ivf_index_scan(qs, cents, 3)[1]
d, i = cs.fused_scan(luts, codes, ids, lens, probe, 5)
p = probe.long()
rd, ri = cs.ref_chamvs_scan(luts, codes[:, p], ids[:, p], lens[:, p], 5)
assert torch.equal(d, rd) and torch.equal(i, ri)
bl, slab = luts[:, 0].contiguous(), codes[0, 0]      # [4, 2, 16], [6, 2]
bn = torch.tensor([6, 0, 2, 5], dtype=torch.int32)
d, i = pq.pq_adc_topk(bl, slab.expand(4, 6, 2), bn, 4)
rd, ri = pq.ref_pq_adc_topk(bl, slab.expand(4, 6, 2), bn, 4)
assert torch.equal(d, rd) and torch.equal(i, ri)
assert torch.equal(pq.pq_shared_scan(bl, slab),
                   pq.ref_shared_scan(bl, slab).T)
row = torch.randn(3, 64, generator=g)
assert all(torch.equal(a, b) for a, b in zip(
    tk.approx_topk(row, 6, num_blocks=4),
    tk.ref_hierarchical_topk(row, 6, 4, tk.truncated_queue_len(6, 4))))
assert all(torch.equal(a, b) for a, b in zip(
    tk.approx_topk(row[:, :63], 6, num_blocks=4),
    tk.ref_exact_topk(row[:, :63], 6)))
assert _build._lib is None
assert all(kern.launches == 0 for kern in _build.kernels().values())
assert sorted(_build.kernels()) == ["adc_scan_launch", "chamvs_scan_launch",
    "decode_attn_launch", "decode_attn_partial_launch",
    "hierarchical_topk_launch", "ivf_scan_launch", "shared_scan_launch"]
""")
    assert p.returncode == 0, p.stdout + p.stderr
