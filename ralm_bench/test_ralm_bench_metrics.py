"""The roofline and MFU arithmetic of the per-layer readers, against
shapes worked by hand (the kernel table's Dec-S rows: fused scan bound
0.1687 ms, decode attention 0.0095 ms, at 3.35 TB/s and 67 TFLOP/s)."""
import importlib
import pathlib

import pytest
import torch

from ralm_bench.peaks import PEAKS, least_seconds

HERE = pathlib.Path(__file__).resolve().parent
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def reader(name):
    return importlib.import_module(f"ralm_bench.metrics.{name}")


def test_decode_attn_bound_dec_s_row():
    # W 32 rows at position 484 (485 valid slots each), 8:8 heads, D 64:
    # K and V 2 * 15520 * 8 * 64 * 2 B, q and out 2 * 32 * 8 * 64 * 2 B,
    # slots and positions 32 * 8 B
    mod = reader("decode_attn_roofline")
    nbytes, ops = mod.attn_cost(32 * 485, 32, 8, 8, 64)
    assert nbytes == 31_784_960 + 65_536 + 256
    assert ops == 4 * 15520 * 8 * 64
    assert least_seconds(nbytes, ops, H100) * 1e3 == pytest.approx(
        0.0095, abs=5e-5)


def test_fused_scan_bound_dec_s_row():
    # 2 shards of 1024 lists of 8606 rows; 32 queries probing 32 lists
    # each, all distinct: codes 1024 * 17212 * 32 B, one LUT a query
    # 32 * 32 * 256 * 4 B, outputs and winners' ids 2 * 32 * 63 * 12 B
    mod = reader("fused_scan_roofline")
    lens = torch.full((2, 1024), 8606)
    probe = torch.arange(1024).view(32, 32)
    nbytes, ops = mod.scan_cost(lens, probe, m=32, kk=63)
    assert nbytes == 564_002_816 + 1_048_576 + 48_384
    assert ops == 32 * 32 * 17212 * 32
    assert least_seconds(nbytes, ops, H100) * 1e3 == pytest.approx(
        0.1687, abs=5e-5)


def test_fused_scan_residual_tables_a_probe():
    # a residual index: one LUT a query and probed list, 32 x 32 of them
    mod = reader("fused_scan_roofline")
    lens = torch.full((2, 1024), 8606)
    probe = torch.arange(1024).view(32, 32)
    nbytes, _ = mod.scan_cost(lens, probe, m=32, kk=63, residual=True)
    assert nbytes == 564_002_816 + 32 * 1_048_576 + 48_384


def test_fused_scan_counts_each_probed_list_once():
    mod = reader("fused_scan_roofline")
    lens = torch.full((2, 1024), 8606)
    shared = torch.arange(32).repeat(32, 1)       # every query, same lists
    nbytes, ops = mod.scan_cost(lens, shared, m=32, kk=63)
    assert nbytes == 32 * 17212 * 32 + 1_048_576 + 48_384
    assert ops == 32 * 32 * 17212 * 32             # each query scans them


def test_mfu_flops_by_hand():
    mod = reader("mfu")
    model = dict(n_layers=2, d_model=4, n_heads=2, n_kv_heads=2, d_head=2,
                 d_ff=8, vocab_size=10)
    # a layer: 4 * (2 + 4) * 2 + 2 * 2 * 4 + 3 * 4 * 8 = 48 + 16 + 96
    assert mod.layer_weights(model) == 160
    # a prompt of 3: 2 * 2 * 160 * 3 matmul, 4 * 2 * 2 * 2 * (1+2+3)
    # attention, 2 * 4 * 10 for the last position's logits
    assert mod.prefill_flops(model, 1, 3) == 1920 + 192 + 80
    # a token at position 3 (4 keys), two rows
    assert mod.decode_flops(model, 2, 3) == 2 * (640 + 128 + 80)


class Traced:
    """A traced run's observation with the launches ``launches``."""
    def __init__(self, name, launches, by_kernel):
        self.model, self.lens, self.peak, self.host = {}, None, H100, None
        self.trace = dict(launches={name: launches}, by_kernel=by_kernel)


def test_probes_feed_their_readers():
    # what each probe records is what its reader reads: the Dec-S rows
    attn = reader("decode_attn_roofline")
    q = torch.zeros(32, 1, 8, 64)
    cache = torch.zeros(1, 1, 8, 64)
    rec = attn.record(q, cache, cache, torch.full((32,), 484), kv_len=None)
    obs = Traced("decode_attn_roofline", [rec, rec],
                 {"decode_attn_kernel<64, 1>": 2 * 0.0095e-3 / 0.5})
    assert attn.read(obs) == pytest.approx(50.0, rel=1e-2)
    scan = reader("fused_scan_roofline")

    class Cfg:
        class ivfpq:
            m, ksub, residual = 32, 256, False
    rec = scan.record(None, None, None, torch.arange(1024).view(32, 32),
                      Cfg, 63)
    obs = Traced("fused_scan_roofline", [rec],
                 {"chamvs_scan_kernel<2, 2048, false>": 0.1687e-3 / 0.25})
    obs.lens = torch.full((2, 1024), 8606)
    assert scan.read(obs) == pytest.approx(25.0, rel=1e-3)
    assert scan.describe(obs) == dict(flushes=1,
                                      distinct_lists_per_flush=1024.0,
                                      probes_per_flush=1024.0)


def test_readers_return_nothing_without_a_source():
    class Obs:
        model, lens, peak, host, trace = {}, None, None, None, None
    for path in sorted((HERE / "metrics").glob("*.py")):
        if path.name != "__init__.py":
            assert reader(path.stem).read(Obs()) is None, path.name
