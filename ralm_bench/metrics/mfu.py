"""``mfu``: the LM operations that the window's prefills and decode
tokens need, over the window's seconds times the card's bf16 peak, in %.

Counted from the shapes (``lm_flops``): two operations per weight a
token for the layers' matrices, the output head only where a logit is
needed (the last prompt position and each decoded token), and causal
attention as the inputs need it: a token at position p attends p + 1
keys, 4 x heads x head size operations each. Prefills admitted and
tokens decoded in the traced run's unprofiled part of the window count
(the first token of a request comes from its prefill)."""


def layer_weights(model: dict) -> int:
    d, f = model["d_model"], model["d_ff"]
    H, KV, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    return d * (H + 2 * KV) * dh + H * dh * d + 3 * d * f


def lm_flops(model: dict, positions: int, keys: int, logits: int) -> float:
    """Operations of ``positions`` token positions whose attention reads
    ``keys`` keys in all, ``logits`` of them unembedded."""
    L, H, dh = model["n_layers"], model["n_heads"], model["d_head"]
    return (2.0 * L * layer_weights(model) * positions
            + 4.0 * L * H * dh * keys
            + 2.0 * model["d_model"] * model["vocab_size"] * logits)


def prefill_flops(model: dict, rows: int, t0: int) -> float:
    return rows * lm_flops(model, t0, t0 * (t0 + 1) // 2, 1)


def decode_flops(model: dict, rows: int, position: int) -> float:
    """One decoded token a row at ``position`` (0-based)."""
    return rows * lm_flops(model, 1, position + 1, 1)


def read(obs):
    host, peak = obs.host, obs.peak
    if not host or not peak or host["window_s"] <= 0:
        return None
    flops = sum(prefill_flops(obs.model, rows, t0)
                for rows, t0 in host["prefills"])
    flops += sum(decode_flops(obs.model, rows, pos)
                 for rows, pos in host["decodes"])
    if flops <= 0:
        return None
    return 100.0 * flops / (host["window_s"] * peak["bf16_flops"])
