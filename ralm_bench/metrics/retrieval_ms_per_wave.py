"""``retrieval_ms_per_wave``: device time of the kernels launched by the
search (query cast, IVF probe, LUTs, fused scan, merge) and the payload
gather, over the decode waves of the profiled window."""


def read(obs):
    tr = obs.trace
    if not tr or not tr["waves"]:
        return None
    dev = tr["by_label"]
    return 1e3 * (dev.get("search", 0.0) + dev.get("resolve", 0.0)) \
        / tr["waves"]
