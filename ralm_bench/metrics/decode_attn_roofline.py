"""``decode_attn_roofline``: the summed least time of the profiled
window's decode-attention launches over the summed device time of
``decode_attn_kernel``, in %.

A launch's least time (``attn_cost``): the bytes are K and V of every
valid slot of every wave row (a row at position p reads min(p + 1,
kv_len) slots; pad rows sit at position 0), the query and the output,
and the slots and positions; the operations four float32 operations a
valid slot, head and dimension. The arithmetic is the kernel table's
(``chip_smoke.py``: ``decode_timed``). The launches' shapes are recorded
at the model's ``decode_attention``."""
from ralm_bench.peaks import least_seconds

PROBE = "repro_torch.models.transformer:decode_attention"
NAME = __name__.rsplit(".", 1)[-1]


def record(q, k_cache, v_cache, position, **kw):
    return position, kw.get("kv_len"), tuple(q.shape), k_cache.shape[2]


def attn_cost(n_valid: float, W: int, H: int, KV: int, D: int,
              elem: int = 2):
    """(bytes, float32 ops) of one launch over ``n_valid`` slots."""
    nbytes = 2 * n_valid * KV * D * elem + 2 * W * H * D * elem + W * 8
    return nbytes, 4.0 * n_valid * H * D


def valid_slots(position, kv_len) -> float:
    """The K/V slots a wave's rows at ``position`` [W] read."""
    p = position.long() + 1
    if kv_len is not None:
        p = p.clamp(max=kv_len)
    return float(p.sum())


def read(obs):
    tr, peak = obs.trace, obs.peak
    launches = (tr or {}).get("launches", {}).get(NAME)
    if not peak or not launches:
        return None
    spent = sum(s for name, s in tr["by_kernel"].items()
                if "decode_attn_kernel" in name)
    if spent <= 0:
        return None
    least, valid = 0.0, {}
    for position, kv_len, (W, _, H, D), KV in launches:
        key = (position.data_ptr(), kv_len)
        if key not in valid:          # the layers of a wave share it
            valid[key] = valid_slots(position, kv_len)
        least += least_seconds(*attn_cost(valid[key], W, H, KV, D), peak)
    return 100.0 * least / spent
