"""``fused_scan_roofline``: the summed least time of the profiled
window's fused-scan launches over the summed device time of
``chamvs_scan_kernel``, in %.

A launch's least time (``scan_cost``): the bytes are the codes of the
lists its queries probe, each list counted once however many queries
probe it, the lookup tables (one a query, or one a query and probed list
for a residual index), the outputs (distance and id of the ``kk`` best
of each shard and query) and the ``kk`` winners' ids gathered; the
operations are one float32 add per code byte scanned for each query. The
arithmetic is the kernel table's ``bound`` (``chip_smoke.py``). The
launches' shapes are recorded at ``fused_shard_scan``."""
from ralm_bench.peaks import least_seconds

PROBE = "repro_torch.retrieval.service:fused_shard_scan"
NAME = __name__.rsplit(".", 1)[-1]


def record(params, stacked, queries, probe_ids, cfg, kk):
    ivf = cfg.ivfpq
    return probe_ids, ivf.m, ivf.ksub, ivf.residual, kk


def scan_cost(lens, probe_ids, m: int, kk: int, ksub: int = 256,
              residual: bool = False):
    """(bytes, float32 ops) of one fused scan: ``lens`` [S, nlist] valid
    rows of each shard's lists, ``probe_ids`` [nq, nprobe]."""
    import torch
    lens = lens.to(torch.float64)
    S = lens.shape[0]
    nq, nprobe = probe_ids.shape
    probed = probe_ids.long()
    distinct = torch.unique(probed)
    codes = float(lens[:, distinct].sum()) * m
    rows = float(lens[:, probed].sum())
    tables = nq * (nprobe if residual else 1)
    nbytes = codes + tables * m * ksub * 4 + S * nq * kk * (8 + 4)
    return nbytes, rows * m


def _launches(obs):
    tr = obs.trace
    return (tr or {}).get("launches", {}).get(NAME) or []


def read(obs):
    tr, peak, launches = obs.trace, obs.peak, _launches(obs)
    if not peak or not launches:
        return None
    spent = sum(s for name, s in tr["by_kernel"].items()
                if "chamvs_scan_kernel" in name)
    if spent <= 0:
        return None
    least = 0.0
    for probe_ids, m, ksub, residual, kk in launches:
        least += least_seconds(*scan_cost(obs.lens, probe_ids.cpu(), m, kk,
                                          ksub, residual), peak)
    return 100.0 * least / spent


def describe(obs):
    """How many distinct lists a flush of the search probes."""
    import torch
    launches = _launches(obs)
    if not launches:
        return None
    probes = [launch[0] for launch in launches]
    return dict(flushes=len(probes),
                distinct_lists_per_flush=sum(
                    int(torch.unique(p).numel()) for p in probes)
                / len(probes),
                probes_per_flush=sum(p.numel() for p in probes)
                / len(probes))
