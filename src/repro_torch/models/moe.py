"""Mixture-of-Experts FFN (twin of ``repro.models.moe``; DBRX: 16 experts
top-4, Phi-3.5-MoE: 16 experts top-2).

Sort-based capacity dispatch, as in the reference: router top-k ->
flatten the (token, expert) assignments -> stable sort by expert -> a
slot within the expert from segment arithmetic -> the kept assignments
into a dense [E, C, d] buffer -> batched expert GEMMs -> a weighted
combine. Assignments past an expert's capacity ``C`` are dropped; the
residual keeps those tokens. ``C`` follows the flat token count N (a
wave's padded bucket in decode), so a row's output depends on its wave,
in the reference as well.

No step synchronizes with the host: dropped assignments land in one
spare buffer row instead of being filtered out. The combine adds each
token's k weighted expert rows in ascending expert order, one rounding
at a time, which is the order of the reference's scatter-add; it uses
no atomics, so it is deterministic on the card.

Sharded (the reference's specs: the experts over "data", each expert's
``f`` over "model"; ``models.parallel``): every rank routes the same
global tokens (the same ``C``, the same drops), fills and runs only its
own experts' [E / D, C, d] rows, each expert's ``f`` columns between
``copy_to_model`` and ``reduce_from_model`` where ``f`` is split, and
all-gathers the experts' outputs over "data" into [E, C, d] for the
combine. An expert's gradient stays on its owner.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import parallel
from repro_torch.models.layers import activation


def route_topk(x: torch.Tensor, router_w: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, d], router_w [d, E] -> (weights [N, k] float32, softmaxed
    over the chosen logits, expert ids [N, k] int64). Routing runs in
    float32; among equal logits the lower expert id comes first (a
    stable descending sort: ``torch.topk`` promises no order there)."""
    logits = x.float() @ router_w.float()
    top_logits, top_ids = torch.sort(logits, dim=-1, descending=True,
                                      stable=True)
    top_logits, top_ids = top_logits[:, :top_k], top_ids[:, :top_k]
    return torch.softmax(top_logits, dim=-1), top_ids


def load_balance_loss(x: torch.Tensor, router_w: torch.Tensor, top_k: int
                      ) -> torch.Tensor:
    """Switch-style auxiliary loss, E * sum_e f_e * p_e: ``f_e`` the share
    of the top-k assignments that go to expert e, ``p_e`` its mean router
    probability (float32). Like the reference's, no loss calls it."""
    logits = x.float() @ router_w.float()
    E = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    top_ids = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[:, :top_k]   # as route_topk
    f = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, top_ids.reshape(-1), torch.ones(top_ids.numel(),
                                            dtype=torch.float32,
                                            device=x.device))
    f = f / torch.clamp(f.sum(), min=1.0)
    return E * torch.sum(f * p.mean(dim=0))


def capacity(N: int, E: int, top_k: int, capacity_factor: float = 1.25
             ) -> int:
    """Slots an expert has for N tokens: ceil(int(N k cf) / E), at
    least 1, rounded up to a multiple of 8 (the reference's formula)."""
    C = max(1, -(-int(N * top_k * capacity_factor) // E))
    return -(-C // 8) * 8


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            split_f: bool = False) -> torch.Tensor:
    """Top-k expert FFN with capacity dropping: x [N, d], router_w
    [d, E], w_gate / w_up [E, d, f], w_down [E, f, d] -> [N, d] in the
    experts' dtype. Experts ``w_gate.shape[0] < E``: this rank's shard
    of experts split over "data" (expert parallelism); ``split_f``: its
    ``f`` columns of each, split over "model"."""
    N, d = x.shape
    E, El = router_w.shape[-1], w_gate.shape[0]
    C = capacity(N, E, top_k, capacity_factor)
    first = 0 if El == E else parallel.expert_rank() * El
    dev = x.device

    gate_w, expert_ids = route_topk(x, router_w, top_k)      # [N, k] each
    flat_e = expert_ids.reshape(-1)                          # [N*k]
    flat_t = torch.arange(N, device=dev).repeat_interleave(top_k)

    # stable sort by expert -> contiguous expert segments; a slot within
    # the expert is the rank less the segment's start
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = torch.zeros(E, dtype=se.dtype, device=dev).scatter_add_(
        0, se, torch.ones_like(se))              # bincount, meta-friendly
    seg_start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(N * top_k, device=dev) - seg_start[se]
    keep = slot < C
    # buffer row of each sorted assignment; every dropped one goes to the
    # spare row E*C, so the kept rows are written once each
    row = torch.where(keep, se * C + slot, E * C)

    # this rank's experts' rows, the others' to the spare row El*C
    mine = keep & (se >= first) & (se < first + El)
    buf = x.new_zeros((El * C + 1, d))
    buf[torch.where(mine, row - first * C, El * C)] = x[flat_t[order]]
    xb = buf[:El * C].view(El, C, d)
    if split_f:
        xb = parallel.copy_to_model(xb)
    g = activation(torch.bmm(xb, w_gate), act)
    y_e = torch.bmm(g * torch.bmm(xb, w_up), w_down)          # [El, C, d]
    if split_f:
        y_e = parallel.reduce_from_model(y_e)
    if El != E:
        y_e = parallel.gather_experts(y_e)                    # [E, C, d]

    # combine: each assignment's expert row (the spare row is zero),
    # weighted in the experts' dtype, then each token's k rows added in
    # ascending expert order
    y_rows = torch.cat([y_e.reshape(E * C, d), y_e.new_zeros((1, d))])
    row_flat = torch.empty_like(row)
    row_flat[order] = row
    y_tok = y_rows[row_flat] * gate_w.reshape(-1, 1).to(y_e.dtype)
    by_expert = torch.sort(expert_ids, dim=-1, stable=True).indices
    y_tok = torch.gather(y_tok.view(N, top_k, d), 1,
                         by_expert[..., None].expand(N, top_k, d))
    out = y_tok[:, 0]
    for j in range(1, top_k):
        out = out + y_tok[:, j]
    return out
