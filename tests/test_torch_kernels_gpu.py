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
import pytest
import torch

from repro_torch.core.ivfpq import adc_scan_ref
from repro_torch.core.kmeans import _pairwise_sq_l2
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
    g = _gen(dev, 0)
    W, P = 13, 20
    k = torch.randn((P, S, KV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((P, S, KV, D), generator=g, device=dev).bfloat16()
    q = torch.randn((W, 1, H, D), generator=g, device=dev).bfloat16()
    slots = torch.randperm(P - 1, generator=g, device=dev)[:W].int()
    hi = (kv_len or S) - 1 if not ring else 3 * S
    pos = torch.randint(0, hi + 1, (W,), generator=g, device=dev).int()
    slots[-1], pos[-1] = P - 1, 0                      # a wave pad row
    kw = dict(window=window, ring=ring, slots=slots, kv_len=kv_len)
    before = da.KERNEL.launches
    out = da.decode_attention(q, k, v, pos, **kw)
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


def test_decode_attention_rejects_what_it_cannot_run(dev):
    q = torch.zeros((2, 1, 8, 64), device=dev)            # float32
    k = torch.zeros((2, 16, 8, 64), device=dev)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, torch.zeros(2, device=dev).int())


# ---------------------------------------------------------------------------
# IVF probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,nlist,D,nprobe", [
    (32, 256, 512, 32), (5, 7, 64, 7), (9, 300, 96, 128), (64, 1000, 512, 1),
    (3, 20, 64, 32),                                   # nprobe > nlist
])
def test_ivf_scan_kernel(dev, nq, nlist, D, nprobe):
    g = _gen(dev, 2)
    cents = torch.randn((nlist, D), generator=g, device=dev)
    queries = torch.randn((nq, D), generator=g, device=dev)
    before = iv.KERNEL.launches
    dk, ik = iv.ivf_index_scan(queries, cents, nprobe)
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


# ---------------------------------------------------------------------------
# shared scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,m,ksub", [
    (1, 5000, 32, 256), (32, 20000, 32, 256), (128, 3001, 32, 256),
    (32, 777, 8, 16),                  # scalar code path, 8 queries/block
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


@pytest.mark.parametrize("n,num_blocks,k", [(500, 16, 10), (64, 16, 10),
                                            (30, 4, 40)])
def test_hierarchical_topk_degenerate_tiling_is_exact(dev, n, num_blocks, k):
    """Tilings the hierarchy cannot split run the same kernel with one
    block per row and k' = k: the exact top-k, in one launch."""
    g = _gen(dev, 9)
    d = torch.randn((4, n), generator=g, device=dev)
    d[3, ::3] = 0.25
    before = tk.KERNEL.launches
    dk, ik = tk.approx_topk(d, k, num_blocks=num_blocks)
    de, ie = tk.ref_exact_topk(d, k)
    torch.cuda.synchronize()
    assert tk.KERNEL.launches == before + 1
    assert torch.equal(ik, ie) and torch.equal(dk, de)


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
