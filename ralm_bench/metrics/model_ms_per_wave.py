"""``model_ms_per_wave``: device time of the LM's kernels in a decode
wave (embedding, GEMMs, norms, RoPE, cache writes, decode attention) and
of the kNN-LM mix, over the decode waves of the profiled window."""


def read(obs):
    tr = obs.trace
    if not tr or not tr["waves"]:
        return None
    dev = tr["by_label"]
    return 1e3 * (dev.get("decode", 0.0) + dev.get("mix", 0.0)) \
        / tr["waves"]
