"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

These run only where there is a card (they skip elsewhere):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Each kernel's wrapper is called on CUDA tensors and held against the
plain version on the same inputs: the fused scan, the staged ADC scan
and the shared scan bit for bit (same float32 summation order), the
hierarchical top-k array for array, the IVF probe up to near-ties of its
FMA order, decode attention against a float32 oracle (only the final
bf16 rounding differs) and against the bf16-rounding plain version.
"""
import pathlib

import pytest
import torch

from repro_torch.core.ivfpq import adc_scan_ref
from repro_torch.core.kmeans import _pairwise_sq_l2
from repro_torch.kernels import registry
from repro_torch.kernels.chamvs_scan import ops as cs
from repro_torch.kernels.decode_attn import ops as da
from repro_torch.kernels.ivf_scan import ops as iv
from repro_torch.kernels.pq_adc import ops as pq
from repro_torch.kernels.topk import ops as tk

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV,D,S,window,ring,kv_len", [
    (8, 8, 64, 512, 0, False, 512),       # Dec-S
    (8, 8, 64, 512, 0, False, 96),        # cropped to kv_len
    (8, 4, 64, 256, 0, False, None),      # G=2
    (8, 2, 128, 256, 0, False, 160),      # G=4, D=128
    (8, 1, 64, 200, 0, False, None),      # G=8, split not a power of two
    (8, 8, 64, 64, 64, True, None),       # ring (sliding layer)
    (8, 4, 128, 48, 32, True, None),      # ring shorter than window wrap
    (8, 8, 64, 512, 48, False, 512),      # linear + window
])
def test_decode_attention_kernel(dev, H, KV, D, S, window, ring, kv_len):
    _check_decode(dev, _gen(dev, 0), H, KV, D, S, window, ring, kv_len)


def _check_decode(dev, g, H, KV, D, S, window, ring, kv_len, W=13, P=20,
                  spec=registry.DEFAULT):
    """One launch against the f32 oracle (2^-8 of the output range) and
    the bf16-rounding plain version (2^-5)."""
    k = torch.randn((P, S, KV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((P, S, KV, D), generator=g, device=dev).bfloat16()
    q = torch.randn((W, 1, H, D), generator=g, device=dev).bfloat16()
    slots = torch.randperm(P - 1, generator=g, device=dev)[:W].int()
    hi = (kv_len or S) - 1 if not ring else 3 * S
    pos = torch.randint(0, hi + 1, (W,), generator=g, device=dev).int()
    slots[-1], pos[-1] = P - 1, 0                      # a wave pad row
    kw = dict(window=window, ring=ring, slots=slots, kv_len=kv_len)
    before = da.KERNEL.launches
    out = da.decode_attention(q, k, v, pos, spec=spec, **kw)
    torch.cuda.synchronize()
    assert da.KERNEL.launches == before + 1
    kg, vg = da._gather_rows(q, k, v, slots, kv_len, ring)
    exact = da.ref_decode_attention(q.float(), kg.float(), vg.float(), pos,
                                    window=window, ring=ring)
    plain = da.ref_decode_attention(q, kg, vg, pos, window=window, ring=ring)
    scale = exact.abs().max().item()
    assert (out.float() - exact).abs().max().item() <= 2 ** -8 * scale + 1e-5
    assert (out.float() - plain.float()).abs().max().item() <= \
        2 ** -5 * scale + 1e-3
    return out


@pytest.mark.parametrize("G,D,S,window,ring,kv_len,tile_n", [
    (1, 64, 512, 0, False, 464, None),     # the serve's cropped kv_len
    (1, 64, 497, 0, False, None, 64),      # ragged last split and tile
    (2, 64, 200, 0, False, None, 48),      # split not a whole tile
    (4, 64, 464, 40, False, 464, 16),      # window, many splits
    (8, 64, 128, 0, False, 40, None),      # kv_len inside one tile
    (1, 128, 200, 24, True, None, 64),     # ring with window, D=128
    (2, 128, 497, 0, False, None, None),
    (4, 128, 96, 48, True, None, 32),      # ring
    (8, 128, 464, 0, False, 30, None),     # kv_len inside one tile
])
def test_decode_attention_tiles(dev, G, D, S, window, ring, kv_len, tile_n):
    """Split lengths that do not divide S (or the 32-slot tile), every G
    at both head dims, ring and window, and kv_len below one tile."""
    KV = 8 // G if G < 8 else 1
    _check_decode(dev, _gen(dev, 10 + G), KV * G, KV, D, S, window, ring,
                  kv_len, W=9, P=12, spec=registry.KernelSpec(tile_n=tile_n))


def test_decode_attention_back_to_back_launches(dev):
    """Two launches in a row on one stream with different inputs, each
    right: the in-kernel merge leaves its counters at 0."""
    g = _gen(dev, 11)
    for S, kv_len in ((512, 464), (512, 496), (300, None)):
        _check_decode(dev, g, 8, 8, 64, S, 0, False, kv_len, W=32, P=33,
                      spec=registry.KernelSpec(tile_n=32))


def test_decode_attention_without_slots(dev):
    g = _gen(dev, 1)
    q = torch.randn((4, 1, 8, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((4, 128, 8, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((4, 128, 8, 64), generator=g, device=dev).bfloat16()
    pos = torch.tensor([0, 5, 127, 64], device=dev, dtype=torch.int32)
    out = da.decode_attention(q, k, v, pos)
    exact = da.ref_decode_attention(q.float(), k.float(), v.float(), pos)
    assert (out.float() - exact).abs().max().item() <= \
        2 ** -8 * exact.abs().max().item() + 1e-5


@pytest.mark.parametrize("W,lo,hi", [(4, 448, 511), (1, 500, 500),
                                     (3, 0, 511)])
def test_decode_attention_per_sequence_caches(dev, W, lo, hi):
    """The per-sequence loop's call: ``slots=None`` over a request's own
    uncropped caches [W, 512, 8, 64] at the positions a 448-token prompt
    reaches in 64 steps, against the f32 oracle (2^-8 of the output
    range) and the bf16-rounding plain version (2^-5)."""
    g = _gen(dev, 20 + W)
    q = torch.randn((W, 1, 8, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((W, 512, 8, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((W, 512, 8, 64), generator=g, device=dev).bfloat16()
    pos = torch.randint(lo, hi + 1, (W,), generator=g, device=dev).int()
    before = da.KERNEL.launches
    out = da.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert da.KERNEL.launches == before + 1
    exact = da.ref_decode_attention(q.float(), k.float(), v.float(), pos)
    plain = da.ref_decode_attention(q, k, v, pos)
    scale = exact.abs().max().item()
    assert (out.float() - exact).abs().max().item() <= 2 ** -8 * scale + 1e-5
    assert (out.float() - plain.float()).abs().max().item() <= \
        2 ** -5 * scale + 1e-3


def test_decode_attention_rejects_what_it_cannot_run(dev):
    q = torch.zeros((2, 1, 8, 64), device=dev)            # float32
    k = torch.zeros((2, 16, 8, 64), device=dev)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, torch.zeros(2, device=dev).int())


# ---------------------------------------------------------------------------
# IVF probe
# ---------------------------------------------------------------------------

def _check_ivf(dev, g, nq, nlist, D, nprobe, spec=registry.DEFAULT):
    """One launch against the plain version: ids equal up to near-ties
    (1e-5 relative) of the two summation orders."""
    cents = torch.randn((nlist, D), generator=g, device=dev)
    queries = torch.randn((nq, D), generator=g, device=dev)
    before = iv.KERNEL.launches
    dk, ik = iv.ivf_index_scan(queries, cents, nprobe, spec=spec)
    dp, ip = iv.ref_ivf_scan(queries, cents, nprobe)
    torch.cuda.synchronize()
    assert iv.KERNEL.launches == before + 1
    full = _pairwise_sq_l2(queries, cents)
    mism = ik != ip
    assert bool(((ik < 0) == (ip < 0)).all())
    valid = ip >= 0
    dk_of = torch.gather(full, 1, ik.clamp(min=0).long())
    dp_of = torch.gather(full, 1, ip.clamp(min=0).long())
    near = (dk_of - dp_of).abs() <= 1e-5 * dp_of.abs()
    assert not bool((mism & valid & ~near).any())
    assert torch.allclose(dk[valid], dp[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,nlist,D,nprobe,tile_c", [
    (32, 256, 512, 32, None), (5, 7, 64, 7, None), (9, 300, 96, 128, None),
    (64, 1000, 512, 1, None),
    (3, 20, 64, 32, None),                             # nprobe > nlist
    (32, 32768, 512, 32, None),                        # SYN-512's nlist
    (9, 1000, 96, 128, 32),            # nprobe 128 over 32-centroid splits
    (40, 5000, 64, 100, 32),           # 157 splits: a four-level merge
])
def test_ivf_scan_kernel(dev, nq, nlist, D, nprobe, tile_c):
    _check_ivf(dev, _gen(dev, 2), nq, nlist, D, nprobe,
               registry.KernelSpec(tile_c=tile_c))


@pytest.mark.parametrize("nq", [1, 32])
@pytest.mark.parametrize("nprobe", [1, 2, 4, 8, 16])
def test_ivf_scan_degrade_rungs(dev, nq, nprobe):
    """The degrade ladder's nprobe rungs at the serve's index shape
    (nlist 256, D 512), for a one-row gateway wave and a full one."""
    _check_ivf(dev, _gen(dev, 30 + nprobe), nq, 256, 512, nprobe)


def test_ivf_scan_back_to_back_launches(dev):
    """Launches in a row on one stream with different inputs and grids,
    each right: the merge leaves its counters at 0."""
    g = _gen(dev, 14)
    for nq, nlist, nprobe in ((32, 32768, 32), (32, 32768, 64),
                              (32, 256, 32), (7, 4000, 16)):
        _check_ivf(dev, g, nq, nlist, 512, nprobe)


def test_ivf_scan_ties_go_to_lower_id(dev):
    g = _gen(dev, 3)
    base = torch.randn((16, 64), generator=g, device=dev)
    cents = torch.cat([base, base, base]).contiguous()     # exact ties x3
    queries = torch.randn((8, 64), generator=g, device=dev)
    dk, ik = iv.ivf_index_scan(queries, cents, 12)
    # every distance appears 3 times, in id order c, c + 16, c + 32
    ik = ik.view(8, 4, 3)
    assert bool((ik[..., 1] == ik[..., 0] + 16).all())
    assert bool((ik[..., 2] == ik[..., 0] + 32).all())
    assert bool((dk.view(8, 4, 3).diff(dim=-1) == 0).all())


@pytest.mark.parametrize("copies,tile_c", [(3, None), (8, 32), (8, 64)])
def test_ivf_scan_ties_across_splits(dev, copies, tile_c):
    """Groups of equal centroids 40 ids apart, cut by 32- and 64-centroid
    splits: each group comes out whole, in id order."""
    g = _gen(dev, 3)
    base = torch.randn((40, 64), generator=g, device=dev)
    cents = base.repeat(copies, 1).contiguous()
    queries = torch.randn((8, 64), generator=g, device=dev)
    nprobe = 4 * copies
    dk, ik = iv.ivf_index_scan(queries, cents, nprobe,
                               spec=registry.KernelSpec(tile_c=tile_c))
    ik = ik.view(8, 4, copies)
    step = 40 * torch.arange(copies, device=dev)
    assert bool((ik == ik[..., :1] + step).all())
    assert bool((dk.view(8, 4, copies).diff(dim=-1) == 0).all())


# ---------------------------------------------------------------------------
# fused ChamVS scan
# ---------------------------------------------------------------------------

def _tables(dev, g, S, nlist, cap, m, ksub, dup_rows=False):
    codes = torch.randint(0, ksub, (S, nlist, cap, m), generator=g,
                          device=dev).to(torch.uint8)
    if dup_rows:                       # every row twice -> exact ties
        codes[:, :, 1::2] = codes[:, :, 0::2]
    ids = torch.arange(S * nlist * cap, device=dev, dtype=torch.int32
                       ).view(S, nlist, cap)
    lens = torch.randint(0, cap + 1, (S, nlist), generator=g, device=dev
                         ).int()
    lens[0, 0] = 0                     # an empty list slice
    lens[-1, -1] = cap                 # a full one
    ids = torch.where(torch.arange(cap, device=dev) < lens[..., None], ids,
                      torch.full_like(ids, -1))
    return codes.contiguous(), ids.contiguous(), lens.contiguous()


@pytest.mark.parametrize("S,nq,nprobe,nlist,cap,m,ksub,kk,residual,dup", [
    (2, 32, 32, 64, 300, 32, 256, 63, False, False),    # Dec-S-like
    (2, 5, 4, 16, 1000, 32, 256, 100, True, True),      # exact ties
    (1, 3, 2, 4, 40, 8, 16, 200, True, False),          # kk > candidates
    (4, 7, 8, 32, 130, 12, 256, 17, False, True),       # scalar code path
])
def test_fused_scan_kernel(dev, S, nq, nprobe, nlist, cap, m, ksub, kk,
                           residual, dup):
    g = _gen(dev, 4)
    codes, ids, lens = _tables(dev, g, S, nlist, cap, m, ksub, dup)
    probe = torch.stack([torch.randperm(nlist, generator=g, device=dev)
                         [:nprobe] for _ in range(nq)]).int()
    if residual:
        luts = torch.rand((nq, nprobe, m, ksub), generator=g, device=dev)
    else:
        luts = torch.rand((nq, 1, m, ksub), generator=g, device=dev
                          ).expand(nq, nprobe, m, ksub)
    before = cs.KERNEL.launches
    dk, ik = cs.fused_scan(luts, codes, ids, lens, probe, kk)
    p = probe.long()
    dp, ip = cs.ref_chamvs_scan(luts, codes[:, p], ids[:, p], lens[:, p], kk)
    torch.cuda.synchronize()
    assert cs.KERNEL.launches == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


@pytest.mark.parametrize("nq", [1, 32])
@pytest.mark.parametrize("nprobe", [1, 2, 4, 8, 16])
def test_fused_scan_degrade_rungs(dev, nq, nprobe):
    """The degrade ladder's nprobe rungs at the serve's shapes (2 shards,
    nlist 256, lists of up to 14 976 codes of m=32, kk=63): the grid's
    ``scan_groups`` falls with nprobe * cap // 4096, to one block per
    (shard, query) at nprobe 1; ids and distances as the plain
    version's."""
    g = _gen(dev, 40 + nprobe)
    S, nlist, cap, m, ksub, kk = 2, 256, 14976, 32, 256, 63
    codes, ids, lens = _tables(dev, g, S, nlist, cap, m, ksub)
    probe = torch.stack([torch.randperm(nlist, generator=g, device=dev)
                         [:nprobe] for _ in range(nq)]).int()
    luts = torch.rand((nq, 1, m, ksub), generator=g, device=dev
                      ).expand(nq, nprobe, m, ksub)
    before = cs.KERNEL.launches
    dk, ik = cs.fused_scan(luts, codes, ids, lens, probe, kk)
    p = probe.long()
    dp, ip = cs.ref_chamvs_scan(luts, codes[:, p], ids[:, p], lens[:, p], kk)
    torch.cuda.synchronize()
    assert cs.KERNEL.launches == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


def test_fused_scan_matches_sequential_adc(dev):
    """The kernel's float32 sum runs in sub-space order 0..m-1, which is
    what ``adc_scan_ref`` does — distances agree bit for bit."""
    g = _gen(dev, 5)
    codes, ids, lens = _tables(dev, g, 1, 4, 64, 32, 256)
    lens.fill_(64)
    luts = torch.randn((1, 1, 32, 256), generator=g, device=dev)
    probe = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    dk, ik = cs.fused_scan(luts, codes, ids, lens, probe, 64)
    d_all = adc_scan_ref(luts[0], codes[0, :1])[0]          # [64]
    assert torch.equal(dk[0, 0], torch.sort(d_all, stable=True).values)


def _check_scan(dev, g, S, nq, nprobe, nlist, cap, m, ksub, kk, residual,
                dup):
    """One launch, held bit for bit against the plain version."""
    codes, ids, lens = _tables(dev, g, S, nlist, cap, m, ksub, dup)
    probe = torch.stack([torch.randperm(nlist, generator=g, device=dev)
                         [:nprobe] for _ in range(nq)]).int()
    if residual:
        luts = torch.rand((nq, nprobe, m, ksub), generator=g, device=dev)
    else:
        luts = torch.rand((nq, 1, m, ksub), generator=g, device=dev
                          ).expand(nq, nprobe, m, ksub)
    before = cs.KERNEL.launches
    dk, ik = cs.fused_scan(luts, codes, ids, lens, probe, kk)
    p = probe.long()
    dp, ip = cs.ref_chamvs_scan(luts, codes[:, p], ids[:, p], lens[:, p], kk)
    torch.cuda.synchronize()
    assert cs.KERNEL.launches == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


@pytest.mark.parametrize("S,nq,nprobe,nlist,cap,m,ksub,kk,residual,dup", [
    (1, 3, 7, 16, 3000, 32, 256, 63, False, True),     # 5 groups, 7 probes
    (2, 3, 5, 8, 4000, 12, 256, 40, True, False),      # m=12, residual
    (1, 2, 5, 8, 5000, 32, 256, cs.MAX_KK, True, False),  # large queue
    (2, 4, 7, 12, 2500, 64, 256, 100, False, False),   # m=64
    (1, 5, 9, 20, 2100, 16, 256, 10, True, True),      # m=16, ties
])
def test_fused_scan_split_groups(dev, S, nq, nprobe, nlist, cap, m, ksub, kk,
                                 residual, dup):
    """Rows split between blocks mid-probe and merged in the launch: lists
    longer than one round of rows, kk at MAX_KK, shared and per-probe
    LUTs, the byte path (every m but 32, and the large queue)."""
    groups = cs.scan_groups(S, nq, nprobe, cap, kk,
                            torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
    assert groups > 1 and nprobe % groups
    _check_scan(dev, _gen(dev, 12), S, nq, nprobe, nlist, cap, m, ksub, kk,
                residual, dup)


def test_fused_scan_back_to_back_launches(dev):
    """Two launches in a row on one stream with different inputs, each
    equal to the plain version: the merge counters reset."""
    g = _gen(dev, 13)
    for residual in (False, True, False):
        _check_scan(dev, g, 2, 32, 32, 64, 2000, 32, 256, 63, residual,
                    False)


# ---------------------------------------------------------------------------
# staged ADC scan (adc_scan)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,m,ksub,k,dup,shared_lut", [
    (64, 1000, 32, 256, 63, False, False),     # ragged lens
    (16, 300, 8, 16, 100, True, False),        # ties, scalar code path
    (8, 14976, 32, 256, 63, False, True),      # serve width, one LUT
    (5, 40, 12, 256, 200, False, False),       # k > n
])
def test_adc_scan_kernel(dev, B, n, m, ksub, k, dup, shared_lut):
    g = _gen(dev, 6)
    codes = torch.randint(0, ksub, (B, n, m), generator=g, device=dev
                          ).to(torch.uint8)
    if dup:                            # every row twice -> exact ties
        codes[:, 1::2] = codes[:, 0::2]
    lens = torch.randint(0, n + 1, (B,), generator=g, device=dev).int()
    lens[0], lens[1], lens[-1] = 0, min(k - 1, n), n   # empty, < k, full
    if shared_lut:                     # stride-0 entries: one LUT for all
        luts = torch.rand((1, m, ksub), generator=g, device=dev
                          ).expand(B, m, ksub)
    else:
        luts = torch.rand((B, m, ksub), generator=g, device=dev)
    before = pq.ADC_KERNEL.launches
    dk, ik = pq.pq_adc_topk(luts, codes, lens, k)
    dp, ip = pq.ref_pq_adc_topk(luts, codes, lens, k)
    torch.cuda.synchronize()
    assert pq.ADC_KERNEL.launches == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    assert bool((ik[0] == -1).all())


def _check_probed(dev, g, nq, nprobe, nlist, cap, m, ksub, k, residual,
                  long_list=False):
    """The in-place wrapper against the gathered one and the plain
    version, bit for bit, one launch each."""
    codes = torch.randint(0, ksub, (nlist, cap, m), generator=g, device=dev
                          ).to(torch.uint8)
    lens = torch.randint(0, cap + 1, (nlist,), generator=g, device=dev).int()
    lens[0], lens[1] = 0, min(k - 1, cap)              # empty, < k
    if long_list:
        lens[2] = cap - 1                              # ends mid-round
    probe = torch.stack([torch.randperm(nlist, generator=g, device=dev)
                         [:nprobe] for _ in range(nq)]).int()
    probe[0, :3] = torch.tensor([0, 1, 2], device=dev)
    if residual:
        luts = torch.rand((nq, nprobe, m, ksub), generator=g, device=dev)
    else:
        luts = torch.rand((nq, 1, m, ksub), generator=g, device=dev
                          ).expand(nq, nprobe, m, ksub)
    before = pq.ADC_KERNEL.launches
    dk, ik = pq.probed_adc_topk(luts, codes, lens, probe, k)
    p = probe.reshape(-1).long()
    g_luts = luts.reshape(nq * nprobe, m, ksub)
    dg, ig = pq.pq_adc_topk(g_luts, codes[p], lens[p], k)
    dp, ip = pq.ref_pq_adc_topk(g_luts, codes[p], lens[p], k)
    torch.cuda.synchronize()
    assert pq.ADC_KERNEL.launches == before + 2
    assert torch.equal(ik.reshape(-1, k), ig) and torch.equal(ig, ip)
    assert torch.equal(dk.reshape(-1, k), dg) and torch.equal(dg, dp)
    assert bool((ik[0, 0] == -1).all())


@pytest.mark.parametrize("nq,nprobe,nlist,cap,m,ksub,k,residual", [
    (32, 32, 64, 3000, 32, 256, 63, False),      # the serve's shapes, small
    (4, 8, 16, 1000, 32, 256, 100, True),        # residual LUTs
    (3, 5, 8, 700, 12, 256, 40, False),          # byte path
    (2, 3, 6, 500, 8, 16, pq.MAX_K, False),      # the large queue
])
def test_adc_scan_in_place_equals_gathered(dev, nq, nprobe, nlist, cap, m,
                                           ksub, k, residual):
    _check_probed(dev, _gen(dev, 15), nq, nprobe, nlist, cap, m, ksub, k,
                  residual)


def test_adc_scan_long_entry_split_mid_round(dev):
    """Lists of up to 30 000 rows over few entries: chunks of at least
    MIN_CHUNK_ROWS rows, eight a full list, the last ending mid-round."""
    assert pq.adc_chunk_rows(2 * 4, 30000, 132) == pq.MIN_CHUNK_ROWS
    _check_probed(dev, _gen(dev, 16), 2, 4, 6, 30000, 32, 256, 63, False,
                  long_list=True)


def test_adc_scan_back_to_back_launches(dev):
    """Launches in a row on one stream with different inputs, each equal
    to the plain version: the merge counters reset."""
    g = _gen(dev, 17)
    for residual, cap in ((False, 9000), (True, 5000), (False, 9000)):
        _check_probed(dev, g, 8, 16, 32, cap, 32, 256, 63, residual,
                      long_list=True)


# ---------------------------------------------------------------------------
# shared scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,m,ksub", [
    (1, 5000, 32, 256), (32, 20000, 32, 256), (128, 3001, 32, 256),
    (32, 777, 8, 16),                  # byte path, four queries a block
])
def test_shared_scan_kernel(dev, q, n, m, ksub):
    g = _gen(dev, 7)
    luts = torch.randn((q, m, ksub), generator=g, device=dev)
    codes = torch.randint(0, ksub, (n, m), generator=g, device=dev
                          ).to(torch.uint8)
    before = pq.SHARED_KERNEL.launches
    out = pq.pq_shared_scan(luts, codes)
    want = pq.ref_shared_scan(luts, codes).T
    torch.cuda.synchronize()
    assert pq.SHARED_KERNEL.launches == before + 1
    assert torch.equal(out, want)
    small = pq.pq_shared_scan(luts, codes, tile_n=256)     # many row chunks
    assert torch.equal(small, want)


@pytest.mark.parametrize("q", [1, 5, 32, 33])
@pytest.mark.parametrize("m,ksub,aligned", [
    (8, 256, True), (16, 256, True), (32, 256, True), (64, 256, True),
    (32, 16, True),                    # ksub != 256
    (32, 256, False),                  # unaligned rows: the byte path
])
def test_shared_scan_shapes(dev, q, m, ksub, aligned):
    """Query counts that fill 1, 2 or 4 queries a block or leave a ragged
    last tile, every m, ksub != 256, unaligned code rows, and row chunks
    that do not divide n: bit for bit the plain version."""
    g = _gen(dev, 23)
    n = 3001
    luts = torch.randn((q, m, ksub), generator=g, device=dev)
    buf = torch.randint(0, ksub, (n * m + 1,), generator=g, device=dev
                        ).to(torch.uint8)
    codes = (buf[:n * m] if aligned else buf[1:]).view(n, m)
    assert (codes.data_ptr() % 16 == 0) == aligned
    want = pq.ref_shared_scan(luts, codes).T
    for tile_n in (None, 1000):
        out = pq.pq_shared_scan(luts, codes, tile_n=tile_n)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# hierarchical top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,k,num_blocks,k_prime", [
    (32, 479232, 100, 16, None),       # the smoke's staged ADC rows
    (16, 8192, 10, 4, None),
    (8, 4096, 1, 8, None),
    (8, 4096, 63, 2, None),
    (8, 2048, 40, 8, 3),               # explicit k' below the sizing
])
def test_hierarchical_topk_kernel(dev, B, n, k, num_blocks, k_prime):
    g = _gen(dev, 8)
    d = torch.randn((B, n), generator=g, device=dev)
    d[:, n // 3:n // 3 + 500] = float("inf")           # padding rows
    d[1] = float("inf")
    d[2, ::2] = 0.5                                    # ties
    kp = k_prime or tk.truncated_queue_len(k, num_blocks)
    kp = min(max(kp, 1), k)
    before = tk.KERNEL.launches
    dk, ik = tk.approx_topk(d, k, num_blocks=num_blocks, k_prime=k_prime)
    dp, ip = tk.ref_hierarchical_topk(d, k, num_blocks, kp)
    torch.cuda.synchronize()
    assert tk.KERNEL.launches == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    assert bool((ik[1] == -1).all())


@pytest.mark.parametrize("B,n,num_blocks,k", [(4, 500, 16, 10),
                                              (4, 64, 16, 10),
                                              (4, 30, 4, 40),
                                              (4, 50001, 16, 63),
                                              (2, 40001, 8, 300)])
def test_hierarchical_topk_degenerate_tiling_is_exact(dev, B, n, num_blocks,
                                                       k):
    """Tilings the hierarchy cannot split run the same kernel with one
    column block per row and k' = k: the exact top-k, in one launch (the
    rows of 50 001 columns are split between blocks, k = 300 takes the
    shared queue)."""
    g = _gen(dev, 9)
    d = torch.randn((B, n), generator=g, device=dev)
    d[-1, ::3] = 0.25
    before = tk.KERNEL.launches
    dk, ik = tk.approx_topk(d, k, num_blocks=num_blocks)
    de, ie = tk.ref_exact_topk(d, k)
    torch.cuda.synchronize()
    assert tk.KERNEL.launches == before + 1
    assert torch.equal(ik, ie) and torch.equal(dk, de)


def _check_topk(dev, d, k, num_blocks, k_prime):
    """One call against the plain version, array for array."""
    kp = min(max(k_prime or tk.truncated_queue_len(k, num_blocks), 1), k)
    before = tk.KERNEL.launches
    dk, ik = tk.approx_topk(d, k, num_blocks=num_blocks, k_prime=k_prime)
    dp, ip = tk.ref_hierarchical_topk(d, k, num_blocks, kp)
    torch.cuda.synchronize()
    assert tk.KERNEL.launches == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    return dk, ik


@pytest.mark.parametrize("k,k_prime", [(10, 1), (100, 15), (100, 32),
                                       (100, 33), (128, 128), (200, 129)])
def test_hierarchical_topk_queue_lengths(dev, k, k_prime):
    """k' at 1 and at each run size's edges (32, 64 < 128, then the shared
    queue past 128), over column blocks split between blocks; a row of
    +inf and a column block with fewer than k' finite entries."""
    g = _gen(dev, 18)
    B, num_blocks, tile = 8, 4, 20000
    assert tk.topk_pieces(B, num_blocks, tile, k, 132) == \
        (1 if k > tk.WARP_MAX_K else 4)
    d = torch.randn((B, num_blocks * tile), generator=g, device=dev)
    d[1] = float("inf")
    d[2, tile:2 * tile] = float("inf")
    d[2, tile + 7:tile + 7 + k_prime // 2] = -0.5     # < k' finite
    d[3, ::5] = 0.0                                   # ties
    _, ik = _check_topk(dev, d, k, num_blocks, k_prime)
    assert bool((ik[1] == -1).all())


def test_hierarchical_topk_tie_group_across_pieces(dev):
    """A group of equal smallest distances cut by the boundaries between
    a column block's pieces: the lower columns win, whichever block of the
    launch held them."""
    g = _gen(dev, 19)
    B, num_blocks, tile, k, k_prime = 2, 2, 20000, 40, 15
    pieces = tk.topk_pieces(B, num_blocks, tile, k, 132)
    assert pieces == 4
    d = torch.rand((B, num_blocks * tile), generator=g, device=dev) + 1.0
    for p in range(1, pieces):                        # piece boundaries
        c = tile * p // pieces
        d[:, c - 6:c + 6] = 0.5
        d[:, tile + c - 9:tile + c + 3] = 0.5
    _, ik = _check_topk(dev, d, k, num_blocks, k_prime)
    assert int(ik[0, 0]) == tile // pieces - 6


def test_hierarchical_topk_keeps_the_truncation(dev):
    """A row whose true top-k lies in one column block: the approximate
    result keeps only that block's k' smallest, so it differs from the
    exact top-k, and it must equal the plain version."""
    g = _gen(dev, 20)
    B, num_blocks, tile, k = 4, 16, 8192, 100
    d = torch.rand((B, num_blocks * tile), generator=g, device=dev) + 1.0
    d[0, 3 * tile:3 * tile + 200] = torch.rand(200, generator=g, device=dev)
    _, ik = _check_topk(dev, d, k, num_blocks, None)
    _, ie = tk.ref_exact_topk(d, k)
    assert not torch.equal(ik[0], ie[0])


def test_hierarchical_topk_back_to_back_launches(dev):
    """Calls in a row on one stream with new inputs and grids, each equal
    to the plain version: the merge counters are back at 0."""
    g = _gen(dev, 21)
    for B, n, num_blocks, k in ((32, 479232, 16, 100), (8, 80000, 4, 63),
                                (32, 479232, 16, 100), (3, 60000, 2, 10)):
        d = torch.randn((B, n), generator=g, device=dev)
        d[:, n // 2:n // 2 + 3000] = float("inf")
        _check_topk(dev, d, k, num_blocks, None)


def test_hierarchical_topk_is_one_kernel(dev):
    """Both levels run in one kernel: the profiler sees one device kernel
    of topk.cu a call."""
    d = torch.randn((32, 479232), generator=_gen(dev, 22), device=dev)
    tk.approx_topk(d, 100)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tk.approx_topk(d, 100)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "topk" in e.key]
    assert [e.count for e in kernels] == [1]


def test_new_wrappers_reject_what_they_cannot_run(dev):
    luts = torch.rand((4, 8, 16), device=dev)
    codes = torch.zeros((4, 32, 8), dtype=torch.uint8, device=dev)
    lens = torch.full((4,), 32, dtype=torch.int32, device=dev)
    for bad in (dict(luts=luts.double()), dict(luts=luts.bfloat16()),
                dict(luts=luts[:, :4]), dict(codes=codes.transpose(1, 2)
                                             .contiguous().transpose(1, 2)),
                dict(lens=lens.long()), dict(codes=codes[:3])):
        args = dict(luts=luts, codes=codes, lens=lens) | bad
        with pytest.raises(ValueError):
            pq.pq_adc_topk(args["luts"], args["codes"], args["lens"], 5)
    with pytest.raises(ValueError):
        pq.pq_adc_topk(luts, codes, lens, pq.MAX_K + 1)
    slab = codes[0]
    for bad_luts, bad_codes in ((luts.bfloat16(), slab),
                                (luts, slab[:, :4]),
                                (luts, slab.T.contiguous().T),
                                (luts.transpose(1, 2).contiguous()
                                 .transpose(1, 2), slab)):
        with pytest.raises(ValueError):
            pq.pq_shared_scan(bad_luts, bad_codes)
    d = torch.randn((4, 256), device=dev)
    for bad in (d.double(), d.T.contiguous().T):
        with pytest.raises(ValueError):
            tk.approx_topk(bad, 5, num_blocks=4)


# ---------------------------------------------------------------------------
# the shapes of the paper's other RALMs: Dec-L and EncDec-L (H = KV = 16,
# D 1024 queries, SYN-1024's m = 64) and EncDec-S (m = 32, RETRO's K = 10)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV,kv_len", [(16, 16, 512), (16, 16, 464)])
def test_decode_attention_at_paper_l_heads(dev, H, KV, kv_len):
    """Dec-L's and EncDec-L's 16 KV heads over the serve pool (W 32)."""
    _check_decode(dev, _gen(dev, 40), H, KV, 64, 512, 0, False, kv_len,
                  W=32, P=33)


@pytest.mark.parametrize("nq", [1, 32])
def test_ivf_scan_at_d1024(dev, nq):
    """The IVF probe over SYN-1024 queries (D 1024, nlist 256)."""
    _check_ivf(dev, _gen(dev, 41), nq, 256, 1024, 32)


@pytest.mark.parametrize("S,nq,nprobe,nlist,cap,m,kk,residual,dup", [
    (2, 32, 32, 64, 300, 64, 63, False, False),   # Dec-L: K 100, 2 shards
    (2, 32, 32, 64, 300, 64, 10, False, False),   # EncDec-L: K 10
    (2, 5, 4, 16, 700, 64, 100, True, True),      # residual, exact ties
    (2, 32, 32, 64, 300, 32, 10, False, False),   # EncDec-S: m 32, K 10
])
def test_fused_scan_at_m64(dev, S, nq, nprobe, nlist, cap, m, kk, residual,
                           dup):
    """The fused scan's generic path (m != 32: a 64 KB LUT a block)
    against the plain version, ids and distances bit for bit."""
    g = _gen(dev, 42)
    codes, ids, lens = _tables(dev, g, S, nlist, cap, m, 256, dup)
    probe = torch.stack([torch.randperm(nlist, generator=g, device=dev)
                         [:nprobe] for _ in range(nq)]).int()
    if residual:
        luts = torch.rand((nq, nprobe, m, 256), generator=g, device=dev)
    else:
        luts = torch.rand((nq, 1, m, 256), generator=g, device=dev
                          ).expand(nq, nprobe, m, 256)
    before = cs.KERNEL.launches
    dk, ik = cs.fused_scan(luts, codes, ids, lens, probe, kk)
    p = probe.long()
    dp, ip = cs.ref_chamvs_scan(luts, codes[:, p], ids[:, p], lens[:, p], kk)
    torch.cuda.synchronize()
    assert cs.KERNEL.launches == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


@pytest.mark.parametrize("nq,nprobe,nlist,cap,k,residual", [
    (32, 32, 64, 3000, 63, False),     # Dec-L's staged scan, small lists
    (32, 32, 64, 3000, 10, False),     # EncDec-L: K 10
    (4, 8, 16, 1000, 100, True),       # residual LUTs
])
def test_adc_scan_at_m64(dev, nq, nprobe, nlist, cap, k, residual):
    """adc_scan's generic path at m 64, in place and gathered, against
    the plain version bit for bit."""
    _check_probed(dev, _gen(dev, 43), nq, nprobe, nlist, cap, 64, 256, k,
                  residual)


def test_retro_engine_on_the_card_matches_the_cpu():
    """A reduced RETRO engine (EncDec-S's family at d_head 64, the
    decode kernel's width; vocab 64; ``xwv``/``xwo`` x 40 so that
    retrieval moves tokens) served on the card gives the tokens and
    retrieval ids of the same engine on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import (DatastoreBuilder, EngineConfig, RagConfig,
                                   RalmEngine, RalmRequest)

    cfg = dataclasses.replace(get_arch("encdec_s").reduced, d_model=256,
                              n_heads=4, n_kv_heads=4, d_head=64,
                              vocab_size=64)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    for name in ("xwv", "xwo"):
        params["classes"]["global"][name] *= 40
    rng = np.random.default_rng(0)
    corpus = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        corpus.append((3 * corpus[-1] + 1) % 64)
    corpus = np.stack(corpus, axis=1).astype(np.int32)       # [64, 32]
    n, L, C = corpus.shape[0], corpus.shape[1], 8
    padded = np.concatenate([corpus, np.zeros((n, C), np.int32)], axis=1)
    chunks = padded[:, np.arange(L - 1)[:, None] + 1 + np.arange(C)
                    ].reshape(n * (L - 1), C)
    builder = DatastoreBuilder(dim=cfg.d_model, nlist=8, m=16, list_cap=512,
                               device="cpu")
    keys, nxt = builder.corpus_keys(params, cfg, corpus)
    ds = builder.build(keys, payload_tokens=nxt, chunk_table=chunks)
    rag = RagConfig(mode="retro", interval=4, k=2, chunk_len=C)

    def run(device):
        eng = RalmEngine.from_config(
            EngineConfig(model=cfg, rag=rag, async_retrieval=True), params,
            ds, ds.search_config(nprobe=4, k=2), device=device)
        traces = [[], []]
        rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=12,
                                       trace=tr))
                for p, tr in zip((corpus[:2, :8], corpus[2:5, :6]), traces)]
        by_id = {r.request_id: r.tokens for r in eng.run()}
        return [by_id[r] for r in rids], traces, eng

    before = da.KERNEL.launches
    gpu, gtr, geng = run("cuda")
    assert da.KERNEL.launches - before == \
        cfg.n_layers * geng.decode_dispatches
    assert geng.pool.enc.is_cuda
    cpu, ctr, _ = run("cpu")
    for a, b in zip(gpu, cpu):
        np.testing.assert_array_equal(a, b)
    for ga, ca in zip(gtr, ctr):
        assert [e["step"] for e in ga] == [e["step"] for e in ca] == [0, 4, 8]
        for ge, ce in zip(ga, ca):
            np.testing.assert_array_equal(ge["ids"], ce["ids"])


# ---------------------------------------------------------------------------
# the dense assigned backbones' head layouts: Qwen2-0.5B (14:2, D 64),
# Phi-3-mini (32:32, D 96), Gemma-3-4B (8:4, D 256; a 1024-slot ring on
# its local layers), Llama-3-405B (128:8, D 128, G 16), Qwen2-VL-72B
# (64:8, D 128) and the reduced configs' D 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV,D,S,window,ring,kv_len", [
    (14, 2, 64, 512, 0, False, 512),        # qwen2_0_5b, G 7
    (32, 32, 96, 512, 0, False, 512),       # phi3_mini_3_8b
    (32, 32, 96, 512, 0, False, 464),       # phi3, the first kv_len crop
    (8, 4, 256, 1024, 1024, True, None),    # gemma3_4b local: the ring
    (8, 4, 256, 512, 0, False, 512),        # gemma3_4b global
    (128, 8, 128, 512, 0, False, 512),      # llama3_405b, G 16
    (64, 8, 128, 512, 0, False, 512),       # qwen2_vl_72b, G 8
    (4, 2, 16, 64, 0, False, 48),           # the reduced configs
    (4, 2, 16, 8, 8, True, None),           # reduced gemma3's ring
])
def test_decode_attention_at_assigned_heads(dev, H, KV, D, S, window, ring,
                                            kv_len):
    """Each backbone's head layout over the serve pool (W 32, P 33):
    ring positions run to three times round the ring."""
    _check_decode(dev, _gen(dev, 50 + D + H), H, KV, D, S, window, ring,
                  kv_len, W=32, P=33)


@pytest.mark.parametrize("G,D,S,window,ring,kv_len,tile_n", [
    (1, 96, 497, 0, False, None, 64),       # ragged last split and tile
    (1, 96, 200, 24, True, None, 48),       # ring + window, split < tile
    (1, 96, 464, 0, False, 30, None),       # kv_len inside one tile
    (2, 256, 1024, 1024, True, None, 352),  # the ring cut in 3 ragged
    (2, 256, 497, 0, False, None, None),
    (2, 256, 128, 0, False, 20, None),      # kv_len inside one tile
    (7, 64, 497, 0, False, None, 96),       # qwen2's G 7
    (16, 128, 497, 0, False, None, 64),     # llama3's G 16
    (16, 128, 200, 24, True, None, None),   # G 16 ring + window
    (16, 64, 464, 0, False, 25, None),      # G 16 at D 64
    (16, 256, 300, 0, False, None, 96),     # G 16 at D 256
    (2, 16, 97, 0, False, None, 32),        # D 16
])
def test_decode_attention_new_shapes_tiles(dev, G, D, S, window, ring,
                                           kv_len, tile_n):
    """The new head dims and G above 8 with split lengths that do not
    divide S (or the 32-slot tile), ring and window, kv_len below one
    tile."""
    KV = max(1, 8 // G)
    _check_decode(dev, _gen(dev, 60 + G + D), KV * G, KV, D, S, window, ring,
                  kv_len, W=9, P=12, spec=registry.KernelSpec(tile_n=tile_n))


@pytest.mark.parametrize("H,KV,D", [(32, 32, 96), (8, 4, 256), (128, 8, 128)])
def test_decode_attention_new_shapes_back_to_back(dev, H, KV, D):
    """Launches in a row on one stream at each new shape, each right:
    the in-kernel merge leaves its counters at 0."""
    g = _gen(dev, 70 + D)
    for S, kv_len in ((512, 464), (512, 496), (300, None)):
        _check_decode(dev, g, H, KV, D, S, 0, False, kv_len, W=8, P=9)


def test_decode_attention_rejects_unbuilt_head_shapes(dev):
    """A head dim the kernel has no instance for, and G above 16, raise
    on the host before anything launches."""
    before = da.KERNEL.launches
    for H, KV, D in ((4, 4, 32), (32, 1, 64)):
        q = torch.zeros((2, 1, H, D), device=dev, dtype=torch.bfloat16)
        k = torch.zeros((2, 16, KV, D), device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="decode kernel supports"):
            da.decode_attention(q, k, k, torch.zeros(2, device=dev).int())
    assert da.KERNEL.launches == before


def _bigram_corpus(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, vocab, size=(64,))]
    for _ in range(31):
        seqs.append((3 * seqs[-1] + 1) % vocab)
    return np.stack(seqs, axis=1).astype(np.int32)           # [64, 32]


@pytest.mark.parametrize("arch,heads", [
    ("llama3_405b", None), ("qwen2_vl_72b", None),
    ("llama3_405b", (16, 1, 128)), ("qwen2_vl_72b", (8, 1, 128))])
def test_assigned_reduced_engine_on_the_card_matches_the_cpu(arch, heads):
    """The reduced Llama-3-405B and Qwen2-VL-72B (as registered: d_head
    16; and with the full models' query heads a KV head at d_head 128,
    Qwen2-VL with its published M-RoPE sections) served as kNN-LMs on
    the card give the CPU's greedy tokens, decode attention launched
    once a layer a wave; one prefill + decode wave's logits agree within
    2^-5 of their range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import (DatastoreBuilder, EngineConfig, RagConfig,
                                   RalmEngine, RalmRequest)

    cfg = dataclasses.replace(get_arch(arch).reduced, vocab_size=64)
    if heads is not None:
        H, KV, D = heads
        over = dict(n_heads=H, n_kv_heads=KV, d_head=D)
        if cfg.rope_mode == "mrope":
            over["mrope_sections"] = get_arch(arch).model.mrope_sections
        cfg = dataclasses.replace(cfg, **over)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    if cfg.qkv_bias:
        g = torch.Generator().manual_seed(1)
        for name in ("bq", "bk", "bv"):
            leaf = params["classes"]["global"][name]
            leaf.copy_(0.5 * torch.randn(leaf.shape, generator=g))
    corpus = _bigram_corpus(64)
    ds = DatastoreBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512,
                          device="cpu").from_corpus(params, cfg, corpus)
    rag = RagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                    temperature=1.0)

    def run(device):
        eng = RalmEngine.from_config(
            EngineConfig(model=cfg, rag=rag, async_retrieval=True), params,
            ds, ds.search_config(nprobe=4, k=8), device=device)
        rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=s))
                for p, s in ((corpus[:2, :8], 8), (corpus[2:5, :6], 6))]
        by_id = {r.request_id: r.tokens for r in eng.run()}
        return [np.asarray(by_id[r]) for r in rids], eng

    before = da.KERNEL.launches
    gpu, geng = run("cuda")
    assert da.KERNEL.launches - before == \
        cfg.n_layers * geng.decode_dispatches
    cpu, _ = run("cpu")
    for a, b in zip(gpu, cpu):
        np.testing.assert_array_equal(a, b)

    def wave_logits(device):
        p = _to(params, device)
        toks = torch.from_numpy(corpus[:4, :10]).to(device)
        caches = tf.init_cache(cfg, 4, 16, device=device)
        tf.forward(p, cfg, toks[:, :9], mode="prefill", caches=caches)
        lg, _ = tf.decode_wave(p, cfg, caches, toks[:, 9:],
                               torch.arange(4, device=device),
                               torch.full((4,), 9, device=device), kv_len=16)
        return lg.float().cpu()

    lg_gpu, lg_cpu = wave_logits("cuda"), wave_logits("cpu")
    scale = lg_cpu.abs().max().item()
    assert (lg_gpu - lg_cpu).abs().max().item() <= 2 ** -5 * scale


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):                 # the hybrid's MambaParams
        return type(tree)(*(_to(v, device) for v in tree))
    return tree.to(device)


# ---------------------------------------------------------------------------
# the non-dense assigned backbones: Hymba-1.5B (25:5, D 64, global and a
# 1024-slot ring), Phi-3.5-MoE (32:8, D 128), DBRX (48:8, D 128),
# SeamlessM4T-medium (16:16, D 64); RWKV-6 has no attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV,D,S,window,ring,kv_len", [
    (25, 5, 64, 512, 0, False, 512),        # hymba_1_5b global, G 5
    (25, 5, 64, 512, 0, False, 464),        # hymba, the first kv_len crop
    (25, 5, 64, 1024, 1024, True, None),    # hymba local: the ring
    (32, 8, 128, 512, 0, False, 512),       # phi3_5_moe_42b, G 4
    (48, 8, 128, 512, 0, False, 512),       # dbrx_132b, G 6
    (16, 16, 64, 512, 0, False, 512),       # seamless_m4t_medium
])
def test_decode_attention_at_nondense_heads(dev, H, KV, D, S, window, ring,
                                            kv_len):
    """Each head layout over the serve pool (W 32, P 33) against the
    plain version (2^-5) and a float32 oracle (2^-8)."""
    _check_decode(dev, _gen(dev, 90 + D + H), H, KV, D, S, window, ring,
                  kv_len, W=32, P=33)


@pytest.mark.parametrize("N,top_k", [(32, 4), (32, 2), (448, 4)])
def test_moe_ffn_on_the_card_is_deterministic(dev, N, top_k):
    """The MoE FFN on the card (no atomics in its combine): two runs are
    bit-equal, and the output agrees with the CPU's within 2^-5 of its
    range (the bf16 GEMMs accumulate in other orders)."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(N + top_k)
    E, d, f = 16, 256, 384
    x = torch.randn((N, d), generator=g).bfloat16()
    router = torch.randn((d, E), generator=g) * 0.1
    ws = [torch.randn(shape, generator=g).mul(0.05).bfloat16()
          for shape in ((E, d, f), (E, d, f), (E, f, d))]
    cpu = moe.moe_ffn(x, router, *ws, top_k)
    args = [t.to(dev) for t in (x, router, *ws)]
    a = moe.moe_ffn(*args, top_k)
    b = moe.moe_ffn(*args, top_k)
    assert torch.equal(a, b)
    scale = cpu.float().abs().max().item()
    assert (a.float().cpu() - cpu.float()).abs().max().item() <= \
        2 ** -5 * scale


@pytest.mark.parametrize("arch", ["hymba_1_5b", "rwkv6_3b", "phi3_5_moe_42b",
                                  "dbrx_132b", "seamless_m4t_medium"])
def test_nondense_reduced_engine_on_the_card_matches_the_cpu(arch):
    """The reduced non-dense backbones served on the card give the CPU's
    greedy tokens (kNN-LMs; SeamlessM4T through RETRO with xwv/xwo x 40),
    decode attention launched once an attention layer a wave (never for
    RWKV-6); one prefill + decode wave's logits agree within 2^-5 of
    their range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import (DatastoreBuilder, EngineConfig, RagConfig,
                                   RalmEngine, RalmRequest)

    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.reduced, vocab_size=64)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    corpus = _bigram_corpus(64)
    builder = DatastoreBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512,
                               device="cpu")
    if cfg.arch == "encdec":
        for leaf in ("xwv", "xwo"):
            params["classes"]["global"][leaf] *= 40.0
        keys, nxt = builder.corpus_keys(params, cfg, corpus)
        n, L = corpus.shape
        padded = np.concatenate([corpus, np.zeros((n, 4), np.int32)], 1)
        idx = np.arange(L - 1)[:, None] + 1 + np.arange(4)[None, :]
        ds = builder.build(keys, payload_tokens=nxt,
                           chunk_table=padded[:, idx].reshape(-1, 4))
        rag = RagConfig(mode="retro", interval=4, k=2, chunk_len=4)
    else:
        ds = builder.from_corpus(params, cfg, corpus)
        rag = RagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                        temperature=1.0)

    def run(device):
        eng = RalmEngine.from_config(
            EngineConfig(model=cfg, rag=rag, async_retrieval=True), params,
            ds, ds.search_config(nprobe=4, k=rag.k), device=device)
        rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=s))
                for p, s in ((corpus[:2, :12], 10), (corpus[2:5, :9], 8))]
        by_id = {r.request_id: r.tokens for r in eng.run()}
        return [np.asarray(by_id[r]) for r in rids], eng

    before = da.KERNEL.launches
    gpu, geng = run("cuda")
    assert da.KERNEL.launches - before == \
        tf.attention_layers(cfg) * geng.decode_dispatches
    cpu, _ = run("cpu")
    for a, b in zip(gpu, cpu):
        np.testing.assert_array_equal(a, b)

    def wave_logits(device):
        p = _to(params, device)
        toks = torch.from_numpy(corpus[:4, :13]).to(device)
        caches = tf.init_cache(cfg, 4, 16, device=device)
        tf.forward(p, cfg, toks[:, :12], mode="prefill", caches=caches)
        lg, _ = tf.decode_wave(p, cfg, caches, toks[:, 12:],
                               torch.arange(4, device=device),
                               torch.full((4,), 12, device=device), kv_len=16)
        return lg.float().cpu()

    lg_gpu, lg_cpu = wave_logits("cuda"), wave_logits("cpu")
    scale = lg_cpu.abs().max().item()
    assert (lg_gpu - lg_cpu).abs().max().item() <= 2 ** -5 * scale


# ---------------------------------------------------------------------------
# disaggregation: memory-node processes on the card
# ---------------------------------------------------------------------------

def _disaggregated_fixture():
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DatastoreBuilder, RagConfig

    cfg = dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    corpus = _bigram_corpus(64)
    ds = DatastoreBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512,
                          device="cpu").from_corpus(params, cfg, corpus)
    rag = RagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                    temperature=1.0)
    prompts = [corpus[:4, :8],
               np.random.default_rng(0).integers(0, 64, size=(2, 8),
                                                 dtype=np.int32)]
    return cfg, params, ds, rag, prompts


def test_disaggregated_engine_on_the_card_matches_the_cpu():
    """A reduced Dec-S served disaggregated on the card (the LM here, two
    memory-node processes on the card) gives the CPU's disaggregated and
    monolithic greedy tokens; each node reports the card, and launched
    the IVF probe and adc_scan once for every search it served, while
    this process launched only decode attention (once a layer a wave)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import os

    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.serve import EngineConfig, RalmEngine

    cfg, params, ds, rag, prompts = _disaggregated_fixture()
    config = EngineConfig(model=cfg, rag=rag, disaggregate=True,
                          ret_devices=2)
    tprompts = [torch.from_numpy(p) for p in prompts]
    with RalmEngine.from_config(config, params, ds,
                                ds.search_config(nprobe=4, k=8),
                                device="cuda") as eng:
        fabric = eng.retriever.router.fabric
        assert fabric.devices == tuple(
            f"cuda:{r % torch.cuda.device_count()}" for r in (1, 2))
        torch.cuda.synchronize()
        _build.reset_launches()
        fabric.reset()
        gpu = eng.generate_batches(tprompts, steps=8)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in _build.kernels().items()}
        nodes = fabric.stats()
        searches = fabric.counters["search"].round_trips
        waves = eng.decode_dispatches
        pids = fabric.pids
    assert not any(fabric.alive())
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    want = dict.fromkeys(launches, 0)
    want["decode_attn_launch"] = cfg.n_layers * waves
    assert launches == want
    assert searches == 8
    for node in nodes:
        assert node["device_name"] == torch.cuda.get_device_name(0)
        assert node["searches"] == searches
        node_want = dict.fromkeys(node["launches"], 0)
        node_want.update(ivf_scan_launch=searches, adc_scan_launch=searches)
        assert node["launches"] == node_want
    with RalmEngine.from_config(config, params, ds,
                                ds.search_config(nprobe=4, k=8),
                                device="cpu") as cpu_eng:
        cpu = cpu_eng.generate_batches(tprompts, steps=8)
    mono = RalmEngine.from_config(
        EngineConfig(model=cfg, rag=rag), params, ds,
        ds.search_config(nprobe=4, k=8, fused=False), device="cuda")
    mono_gpu = mono.generate_batches(tprompts, steps=8)
    for a, b, c in zip(gpu, cpu, mono_gpu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_disaggregated_node_kernel_refusal_raises_at_the_coordinator():
    """A node whose IVF probe refuses its launch (nprobe above the
    kernel's MAX_NPROBE) makes the coordinator raise with the node's
    error; nothing runs in its place, and the nodes stay up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import dataclasses

    from repro_torch.retrieval import FabricError
    from repro_torch.serve import DistributedRetriever
    from repro_torch.launch.mesh import make_mesh_for

    cfg, params, ds, rag, prompts = _disaggregated_fixture()
    dsc = ds.to("cuda")
    bad = dataclasses.replace(dsc.search_config(nprobe=4, k=8),
                              nprobe=iv.MAX_NPROBE + 1)
    mesh = make_mesh_for(data=2, device="cuda")
    with DistributedRetriever(mesh, dsc.params, dsc.shards, bad,
                              payload_tokens=dsc.payload_tokens) as r:
        q = torch.randn(4, cfg.d_model, device="cuda")
        with pytest.raises(FabricError, match="ivf_index_scan"):
            r.search(q)
        fabric = r.router.fabric
        assert all(fabric.alive()) and not fabric.closed
        assert [n["searches"] for n in fabric.stats()] == [0, 0]
        assert all(n["launches"]["ivf_scan_launch"] == 0
                   for n in fabric.stats())
    assert not any(fabric.alive())


# ---------------------------------------------------------------------------
# training on the card: the reduced train steps against the CPU's, a crash
# and resume bit for bit, the FA2 backward against plain autograd
# ---------------------------------------------------------------------------

def _train_batch(cfg, seed, B=4, T=32):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][0, 5] = -1
    if cfg.arch == "encdec":
        batch["enc_embeds"] = torch.randn(
            (B, 16, cfg.d_model), generator=g).to(cfg.torch_dtype)
    return batch


@pytest.mark.parametrize("arch", ["dec_s", "encdec_s", "hymba_1_5b"])
def test_reduced_train_steps_on_the_card_match_the_cpu(dev, arch):
    """Three train steps (bf16, bf16 moments, remat) from the same seeded
    weights: each loss within 2^-7 relative of the CPU's, every
    parameter leaf after them within 2^-5 of its range plus 2 x lr a
    step (Adam's normalised step moves an element whose near-zero
    gradient parts in sign between the two devices by up to lr, either
    way)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    cfg = get_arch(arch).reduced
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = build_train_step(cfg, ocfg)
    cpu = tf.init_params(torch.Generator().manual_seed(0), cfg)
    gpu = tree_lib.map(lambda t: t.to(dev, copy=True), cpu)
    cpu_opt = adamw.init_opt_state(cpu, ocfg)
    gpu_opt = adamw.init_opt_state(gpu, ocfg)
    steps = 3
    for s in range(steps):
        b = _train_batch(cfg, s)
        cpu, cpu_opt, mc = step(cpu, cpu_opt, b)
        gpu, gpu_opt, mg = step(gpu, gpu_opt, _to(b, dev))
        assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
            2 ** -7 * abs(float(mc["loss"])), s
    for a, b in zip(tree_lib.leaves(gpu), tree_lib.leaves(cpu)):
        assert a.device.type == dev.type and a.dtype == b.dtype
        scale = b.float().abs().max().item()
        assert (a.float().cpu() - b.float()).abs().max().item() <= \
            2 ** -5 * scale + 2 * ocfg.lr * steps


def test_train_crash_resume_is_bit_equal_on_the_card(dev, tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import (SimulatedFailure,
                                                     TrainController)

    cfg = get_arch("dec_s").reduced
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    data = SyntheticTokens(DataConfig(seq_len=64, global_batch=8,
                                      vocab_size=cfg.vocab_size))
    step = build_train_step(cfg, ocfg, microbatches=2)

    def fresh():
        p = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        return p, adamw.init_opt_state(p, ocfg)
    a = TrainController(step, data, tmp_path / "a", ckpt_every=3)
    a.run(*fresh(), total_steps=9)
    b = TrainController(step, data, tmp_path / "b", ckpt_every=3)
    b.fail_at = 6
    with pytest.raises(SimulatedFailure):
        b.run(*fresh(), total_steps=9)
    b.run(*fresh(), total_steps=9)
    assert [m["step"] for m in b.metrics_log] == list(range(9))
    assert [m["loss"] for m in b.metrics_log] == \
        [m["loss"] for m in a.metrics_log]


def test_sharded_train_step_on_the_card_matches_the_cpu(dev, tmp_path):
    """``launch.train --model 2`` (two ranks sharing the card over gloo,
    the sharded step) against one rank on the CPU, reduced Dec-S in bf16
    with bf16 moments, 3 steps from the same weights (the CPU's seeded
    init, which the card's run resumes as its step-0 checkpoint: a
    generator on the card draws other numbers): each loss within 2^-7
    relative, every parameter after them within 2^-5 of its range plus
    2 x lr a step (the bounds above)."""
    sharded_train_against_the_cpu(tmp_path, "dec_s", 1, 2)


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "rwkv6_3b",
                                  "hymba_1_5b"])
def test_sharded_nondense_train_steps_on_the_card_match_the_cpu(dev, tmp_path,
                                                                arch):
    """As ``test_sharded_train_step_on_the_card_matches_the_cpu``, at
    ``--data 2 --model 2`` on the reduced non-dense models: the MoE's
    experts split over "data" (each rank routing the global batch), the
    RWKV-6 block and Hymba's Mamba head split over "model"."""
    sharded_train_against_the_cpu(tmp_path, arch, 2, 2)


def sharded_train_against_the_cpu(tmp_path, arch, data, model):
    """The launcher on ``data x model`` ranks sharing the card against
    one rank on the CPU (``test_sharded_train_step_on_the_card_matches_
    the_cpu``'s run and bounds)."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.launch import dp, train
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    root = pathlib.Path(__file__).resolve().parents[1]
    args = ["--arch", arch, "--reduced", "--steps", "3", "--seq-len",
            "32", "--batch", "4", "--ckpt-every", "3"]
    cpu_args = args + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "cpu")]
    cfg, ocfg, _ = train.setup(train.parser().parse_args(cpu_args))
    ckpt_lib.save(tmp_path / "card", 0, train.init_state(cfg, ocfg, "cpu"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args, "--data", str(data), "--model", str(model),
                        "--ckpt-dir", str(tmp_path / "card")],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(root))
    assert p.returncode == 0, p.stdout + p.stderr
    assert f"mesh data {data} x model {model}" in p.stdout
    card = [json.loads(ln.split(" ", 3)[3]) for ln in p.stdout.splitlines()
            if ln.startswith("[train] step ")]
    cpu = train.run(dp.Group.single("cpu"), cpu_args).metrics_log
    assert len(card) == len(cpu) == 3
    for mg, mc in zip(card, cpu):
        assert abs(mg["loss"] - mc["loss"]) <= 2 ** -7 * abs(mc["loss"])
        assert mg["model_mb"] > 0
    like = tf.init_params(None, cfg)
    like = (like, adamw.init_opt_state(like, ocfg))
    got, want = (ckpt_lib.restore(tmp_path / d, like, step=3,
                                  device="cpu")[0][0]
                 for d in ("card", "cpu"))
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(want)):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= \
            2 ** -5 * scale + 2 * ocfg.lr * 3


@pytest.mark.parametrize("B,T,S,H,KV,causal,window", [
    (2, 96, 96, 8, 8, True, 0),
    (2, 80, 144, 8, 2, False, 0),
    (1, 128, 128, 4, 1, True, 48),
])
def test_flash_attention_backward_on_the_card(dev, B, T, S, H, KV, causal,
                                              window):
    """The autograd Function at 32-wide blocks (several, a short last
    one) in bf16 against autograd through the plain masked softmax in
    float32: out, dq, dk, dv within 2^-8 of each one's range, max - min
    (rounding a bf16 output alone costs up to 2^-8 of its largest
    magnitude)."""
    from repro_torch.models import attention as attn

    g = _gen(dev, 3)
    D = 64
    q = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, KV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, KV, D), generator=g, device=dev).bfloat16()
    do = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
    qpos = torch.arange(T, device=dev)[None].expand(B, T) + (S - T)
    kpos = torch.arange(S, device=dev)[None].expand(B, S)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn.flash_attention(*ins, qpos, kpos, causal=causal,
                               window=window, q_block=32, k_block=32)
    grads = torch.autograd.grad(out, ins, do)
    ref_ins = [t.float().requires_grad_(True) for t in (q, k, v)]
    qq, kk, vv = ref_ins
    kk2 = attn._repeat_kv(kk, H // KV)
    vv2 = attn._repeat_kv(vv, H // KV)
    s = torch.einsum("bthd,bshd->bhts", qq, kk2) * D ** -0.5
    msk = attn._mask(qpos, kpos, causal, window)[:, None]
    w = torch.softmax(torch.where(msk, s, attn.NEG_INF), -1)
    w = torch.where(msk.any(-1, keepdim=True), w, 0.0)
    ref = torch.einsum("bhts,bshd->bthd", w, vv2)
    ref_grads = torch.autograd.grad(ref, ref_ins, do.float())
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        span = (want.max() - want.min()).item()
        assert (got.float() - want).abs().max().item() <= 2 ** -8 * span


# ---------------------------------------------------------------------------
# the dry run's steps, the search tools and the quickstart on the card
# ---------------------------------------------------------------------------

def _one_position():
    from repro_torch.launch.mesh import Mesh
    return Mesh(("data", "model"), (1, 1), ("cuda:0",))


def test_serve_steps_on_the_card_match_the_cpu(dev):
    """Reduced Dec-S (bf16, as registered) through ``build_prefill_step``
    and 8 greedy ``build_serve_step`` steps over a one-shard residual
    index on the card: decode attention launches once a layer a step,
    the IVF probe and the fused scan once a step. The fifth step's state
    is copied to the CPU and run there, its search taking the card's
    query (the devices' bf16 hidden states part in their last bits):
    log-probs within 2^-5 of their range, the search's ids identical,
    and every greedy token equal whose CPU margin exceeds twice the
    log-probs' difference."""
    import dataclasses

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_arch
    from repro_torch.core.chamvs import stack_shards
    from repro_torch.launch import specs, steps
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DatastoreBuilder

    spec = get_arch("dec_s")
    spec = dataclasses.replace(spec, model=spec.reduced)
    cfg = spec.model
    db = specs.ServeDBSpec(n_vectors=4096, nlist=16, nprobe=4)
    mesh = _one_position()
    prefill, _ = steps.build_prefill_step(spec, "prefill_32k", mesh)
    serve, _, (ccfg, _) = steps.build_serve_step(spec, "decode_32k", mesh,
                                                 db=db)
    g = torch.Generator().manual_seed(0)
    vecs = torch.randn(2048, ccfg.ivfpq.dim, generator=g)
    ds = DatastoreBuilder(dim=ccfg.ivfpq.dim, nlist=16, m=ccfg.ivfpq.m,
                          list_cap=None, residual=True, num_shards=1,
                          device="cpu").build(vecs)
    assert ds.index_cfg.m == ccfg.ivfpq.m and ds.index_cfg.residual
    payload = torch.randint(0, cfg.vocab_size, (4096,), generator=g,
                            dtype=torch.int32)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                           dtype=torch.int32)
    stacked = stack_shards(ds.shards)
    p = _to(params, dev)
    gstacked = tree_lib.map(lambda t: t.to(dev), stacked)
    gdbp = tree_lib.map(lambda t: t.to(dev), ds.params)
    search, seen = serve.search, []

    def recording(*a):
        seen.append((a[2], search(*a)))
        return seen[-1][1]

    serve.search = recording
    caches = tf.init_cache(cfg, 4, 32, device=dev)
    pos = torch.arange(16, device=dev)[None].expand(4, 16)
    before = (da.KERNEL.launches, iv.KERNEL.launches, cs.KERNEL.launches)
    _, caches = prefill(p, caches, {"tokens": tokens.to(dev),
                                    "positions": pos})
    tok = tokens[:, -1:].to(dev)
    for s in range(8):
        batch = {"token": tok, "position": torch.full(
            (4,), 16 + s, dtype=torch.int32, device=dev)}
        if s == 4:
            state = (tree_lib.map(lambda t: t.cpu(), caches),
                     {k: v.cpu() for k, v in batch.items()})
        logp, caches = serve(p, caches, batch, gdbp, gstacked,
                             payload.to(dev))
        if s == 4:
            card_logp, (query, (_, card_ids)) = logp.float().cpu(), seen[-1]
        tok = logp.argmax(-1, keepdim=True).int()
    torch.cuda.synchronize()
    assert (da.KERNEL.launches - before[0], iv.KERNEL.launches - before[1],
            cs.KERNEL.launches - before[2]) == (cfg.n_layers * 8, 8, 8)
    serve.search = lambda dbp, st, q: recording(dbp, st, query.cpu())
    cpu_logp, _ = serve(params, state[0], state[1], ds.params, stacked,
                        payload)
    serve.search = search
    assert torch.equal(seen[-1][1][1], card_ids.cpu())
    err = (card_logp - cpu_logp).abs().max().item()
    assert err <= 2 ** -5 * (cpu_logp.max() - cpu_logp.min()).item()
    top2 = cpu_logp.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * err
    assert torch.equal(card_logp.argmax(-1)[sure], cpu_logp.argmax(-1)[sure])


def test_search_tools_on_the_card_match_the_cpu(dev):
    """``exact_search`` (planted equal distances) and ``search_single``
    fused and staged on the card: ids identical to the CPU's but at near
    ties (``id_swaps``: the two devices' distance GEMMs round
    differently), the planted tie group in index order; one probe and
    one fused scan launch a fused call, one ``adc_scan`` a shard a
    staged call."""
    from repro_torch.core import chamvs
    from repro_torch.core.ivfpq import exact_search, id_swaps
    from repro_torch.serve import DatastoreBuilder

    g = torch.Generator().manual_seed(0)
    vecs = torch.randn(6000, 64, generator=g)
    vecs[100:110] = vecs[7]
    queries = torch.randn(32, 64, generator=g)
    queries[:4] = vecs[7] + 0.5
    d_c, i_c = exact_search(vecs, queries, 20)
    d_g, i_g = exact_search(vecs.to(dev), queries.to(dev), 20)
    id_swaps(d_g, i_g, d_c, i_c, terms=2 * (queries * queries).sum(1))
    assert i_g[0, :11].tolist() == [7] + list(range(100, 110))
    ds = DatastoreBuilder(dim=64, nlist=32, m=16, num_shards=4,
                          list_cap=None, device="cpu").build(vecs)
    gds = ds.to(dev)
    for fused in (True, False):
        cfg = ds.search_config(nprobe=8, k=20, fused=fused)
        d0, i0 = chamvs.search_single(ds.params, ds.shards, queries, cfg)
        before = (iv.KERNEL.launches, cs.KERNEL.launches,
                  pq.ADC_KERNEL.launches)
        d1, i1 = chamvs.search_single(gds.params, gds.shards,
                                      queries.to(dev), cfg)
        torch.cuda.synchronize()
        assert (iv.KERNEL.launches - before[0],
                cs.KERNEL.launches - before[1],
                pq.ADC_KERNEL.launches - before[2]) == \
            ((1, 1, 0) if fused else (1, 0, 4))
        id_swaps(d1, i1, d0, i0)
    chamvs._SERVICE_MEMO.clear()


def test_quickstart_on_the_card_agrees_with_the_plain_versions(dev, capsys):
    from repro_torch.examples import quickstart

    out = quickstart.main([])                  # raises if card != plain
    assert out["device"] == "cuda" and 0.0 < out["recall"] <= 1.0
    assert "the card's kernels agree with the plain versions: dists " \
           "within 1e-5" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the scans at an m whose LUT does not fit in shared memory (Phi-3.5-MoE's
# m 256, DBRX's 384, Qwen2-VL-72B's 512, Llama-3-405B's 1024): the LUT is
# read from global memory, the sums keep their order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [256, 384, 512, 1024])
@pytest.mark.parametrize("kk,residual", [(63, False), (63, True),
                                         (10, False), (300, True)])
def test_fused_scan_above_shared_memory(dev, m, kk, residual):
    """kk 63 (K 100 over 2 shards, as served), 10 (RETRO's K) and a queue
    past the small one; shared and per-probe LUTs; ids identical and
    distances bit-equal to the plain version."""
    _check_scan(dev, _gen(dev, 60 + m), 2, 4, 8, 16, 700, m, 256, kk,
                residual, False)


@pytest.mark.parametrize("m", [256, 384, 512, 1024])
@pytest.mark.parametrize("k,residual", [(63, False), (63, True),
                                        (10, True), (200, False)])
def test_adc_scan_above_shared_memory(dev, m, k, residual):
    """adc_scan's warp-select path (k <= 128, the staged serve's k 63 and
    RETRO's 10) and its queue path (k 200), in place and gathered, bit
    for bit the plain version."""
    _check_probed(dev, _gen(dev, 70 + m), 4, 8, 16, 1500, m, 256, k,
                  residual, long_list=True)


@pytest.mark.parametrize("q", [1, 5])
def test_shared_scan_above_shared_memory(dev, q):
    """m 256 at ksub 256: one query a block, its LUT read from global
    memory; torch.equal to the plain version."""
    g = _gen(dev, 80 + q)
    luts = torch.randn((q, 256, 256), generator=g, device=dev)
    codes = torch.randint(0, 256, (5001, 256), generator=g, device=dev
                          ).to(torch.uint8)
    assert pq.shared_tile_q(q, 256, 256) == 1
    before = pq.SHARED_KERNEL.launches
    out = pq.pq_shared_scan(luts, codes)
    want = pq.ref_shared_scan(luts, codes).T
    torch.cuda.synchronize()
    assert pq.SHARED_KERNEL.launches == before + 1
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# decode attention's partial mode: a sequence split over ranks
# ---------------------------------------------------------------------------

def _check_partial(dev, g, H, KV, D, S, R, pos, tile_n=None, window=0,
                   ring=False):
    """The cache's S slots (a linear cache, or a ring of S) cut into R
    ranges, each attended by one launch in partial mode with its slot
    offset, merged by ``merge_partials``: against a float32 oracle over
    the whole cache (2^-8 of the output range) and the bf16-rounding
    plain version (2^-5). Returns each range's l."""
    from repro_torch.kernels.decode_attn.ref import merge_partials
    W = pos.shape[0]
    k = torch.randn((W, S, KV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((W, S, KV, D), generator=g, device=dev).bfloat16()
    q = torch.randn((W, 1, H, D), generator=g, device=dev).bfloat16()
    n = S // R
    spec = registry.KernelSpec(tile_n=tile_n)
    parts = []
    before = da.PARTIAL_KERNEL.launches
    for r in range(R):
        kr = k[:, r * n:(r + 1) * n].contiguous()
        vr = v[:, r * n:(r + 1) * n].contiguous()
        parts.append(da.decode_attention_partial(
            q, kr, vr, pos, slot_offset=r * n, window=window,
            ring_size=S if ring else None, spec=spec))
    torch.cuda.synchronize()
    assert da.PARTIAL_KERNEL.launches == before + R
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    assert bool(torch.isfinite(acc).all() and torch.isfinite(m).all())
    out = merge_partials(acc, m, l)
    exact = da.ref_decode_attention(q.float(), k.float(), v.float(),
                                    pos, window=window, ring=ring)[:, 0]
    plain = da.ref_decode_attention(q, k, v, pos, window=window,
                                    ring=ring)[:, 0]
    scale = exact.abs().max().item()
    assert (out - exact).abs().max().item() <= 2 ** -8 * scale + 1e-5
    assert (out - plain.float()).abs().max().item() <= 2 ** -5 * scale + 1e-3
    return l


@pytest.mark.parametrize("H,KV,D", [(8, 8, 64), (16, 16, 64), (8, 2, 128)])
@pytest.mark.parametrize("R", [2, 4])
def test_decode_attention_partial_mode(dev, H, KV, D, R):
    """Dec-S's and Dec-L's head shapes (and a GQA one) over 512 slots cut
    in R ranges; ragged positions, one row in the first range only, one
    at the last slot: each range's partial, merged, against the oracle
    and the plain version; the rows whose range lies past their position
    weigh nothing (l = 0)."""
    g = _gen(dev, 90 + R)
    pos = torch.randint(0, 512, (12,), generator=g, device=dev).int()
    pos[0], pos[1], pos[2] = 3, 511, 512 // R
    l = _check_partial(dev, g, H, KV, D, 512, R, pos)
    assert bool((l[1:, 0] == 0).all())                 # an empty range
    assert bool((l[:, 1] > 0).all())


@pytest.mark.parametrize("tile_n", [32, 48, None, 16])
def test_decode_attention_partial_splits(dev, tile_n):
    """Ragged splits inside a range (200 slots in splits of 48 or 16, or
    as ``pick_split`` cuts them)."""
    g = _gen(dev, 95)
    pos = torch.randint(0, 400, (9,), generator=g, device=dev).int()
    pos[0] = 210
    _check_partial(dev, g, 8, 8, 64, 400, 2, pos, tile_n=tile_n)


@pytest.mark.parametrize("window", [1024, 300])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("H,KV,D", [(25, 5, 64), (8, 4, 256)])
def test_decode_attention_partial_ring(dev, H, KV, D, R, window):
    """Hymba's and Gemma-3's heads over a ring of 1024 slots cut in R
    ranges (a local layer's ring on a mesh), with their window (1024) and
    a shorter one: rows whose ring has wrapped, rows not yet full, one at
    position 0 (one valid slot: the other ranges weigh nothing)."""
    g = _gen(dev, 100 + R + window)
    pos = torch.randint(0, 3000, (12,), generator=g, device=dev).int()
    pos[0], pos[1], pos[2], pos[3] = 0, 700, 1023, 1040
    l = _check_partial(dev, g, H, KV, D, 1024, R, pos, window=window,
                       ring=True)
    assert bool((l[1:, 0] == 0).all())
    assert bool((l.sum(0) > 0).all())


# ---------------------------------------------------------------------------
# the sharded serve steps on the card
# ---------------------------------------------------------------------------

def test_sharded_serve_steps_on_the_card_match_the_cpu(dev, tmp_path,
                                                       monkeypatch):
    """Reduced Dec-S (bf16, as registered) through the sharded prefill and
    3 serve steps on 4 ranks sharing the card (2 x 2 over gloo, the entry
    ``tests/torch_serve_ranks.py``), against the one-position steps on
    the CPU from the same init, index and inputs, the CPU searching the
    card's queries (the devices' bf16 hidden states part in their last
    bits): every step's log-probs within 2^-5 of their range, the greedy
    tokens equal wherever the CPU's margin exceeds twice that
    difference, the search ids equal but at near ties
    (``ivfpq.id_swaps``), and rank 0's launches: decode attention's
    partial mode once a layer a step, the IVF probe and the fused scan
    once a step."""
    _sharded_steps_on_the_card(dev, tmp_path, monkeypatch, "dec_s")


@pytest.mark.parametrize("arch", ["hymba_1_5b", "rwkv6_3b",
                                  "phi3_5_moe_42b"])
def test_sharded_nondense_steps_on_the_card_match_the_cpu(
        dev, tmp_path, monkeypatch, arch):
    """As the Dec-S test, for reduced Hymba (a linear and two ring
    caches, the Mamba state split over "model"), RWKV-6 (no decode
    attention) and Phi-3.5-MoE (the MoE over the global batch)."""
    _sharded_steps_on_the_card(dev, tmp_path, monkeypatch, arch)


def _sharded_steps_on_the_card(dev, tmp_path, monkeypatch, arch):
    import os

    import torch_serve_ranks
    from repro_torch.core.chamvs import stack_shards
    from repro_torch.core.ivfpq import id_swaps
    from repro_torch.launch import dp, specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DatastoreBuilder

    spec = torch_serve_ranks.spec_of(arch, "bfloat16")
    cfg = spec.model
    B, S, T0 = 8, 32, 16
    db = dict(n_vectors=4096, nlist=16, nprobe=4)
    ccfg = specs.ServeDBSpec(**db).for_model(cfg, 2, spec.rag.k)
    g = torch.Generator().manual_seed(3)
    ds = DatastoreBuilder(dim=ccfg.ivfpq.dim, nlist=16, m=ccfg.ivfpq.m,
                          list_cap=ccfg.ivfpq.list_cap, residual=True,
                          num_shards=2, device="cpu").build(
        torch.randn(2048, ccfg.ivfpq.dim, generator=g))

    def ints(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             dtype=torch.int32)
    case = dict(
        arch=arch, dtype="bfloat16",
        params=tf.init_params(torch.Generator().manual_seed(0), cfg),
        shapes=dict(prefill=dict(seq_len=S, global_batch=B),
                    decode=dict(seq_len=S, global_batch=B)),
        db=db, db_params=ds.params, db_shard=stack_shards(ds.shards),
        payload=ints(db["n_vectors"]),
        prefill={"tokens": ints(B, T0), "positions": torch.arange(
            T0, dtype=torch.int32)[None].expand(B, T0).contiguous()},
        steps=[{"token": ints(B, 1), "position": torch.full(
            (B,), T0 + s, dtype=torch.int32)} for s in range(3)])
    torch.save([case], tmp_path / "cases.pt")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(pathlib.Path(__file__).resolve().parent)]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    dp.launch(4, "torch_serve_ranks:run",
              [str(tmp_path / "cases.pt"), str(tmp_path)], device="cuda",
              timeout_s=600, model=2)
    card = torch.load(tmp_path / "result.pt", weights_only=False)[0]
    want = {"decode_attn_partial_launch": tf.attention_layers(cfg) * 3,
            "ivf_scan_launch": 3, "chamvs_scan_launch": 3}
    assert {k: v for k, v in card["launches"].items() if v} == {
        k: v for k, v in want.items() if v}
    cpu = torch_serve_ranks.run_case(
        dp.Group.single("cpu"), case, queries=card["queries"],
        mesh=Mesh(("data", "model"), (1, 1), ("cpu",)))
    for mine, want in zip([card["prefill"]] + card["serve"],
                          [cpu["prefill"]] + cpu["serve"]):
        mine, want = mine.float().cpu(), want.float()
        err = (mine - want).abs().max().item()
        assert err <= 2 ** -5 * (want.max() - want.min()).item()
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * err
        assert torch.equal(mine.argmax(-1)[sure], want.argmax(-1)[sure])
    for (dc, ic), (dw, iw) in zip(card["search"], cpu["search"]):
        id_swaps(dc, ic, dw, iw)
