"""Primitive layers (twin of ``repro.models.layers``): RMSNorm, the gated
MLP, rotary position embeddings (RoPE and Qwen2-VL's M-RoPE)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: (act(x @ w_gate) * (x @ w_up)) @ w_down."""
    g = x @ w_gate
    g = F.silu(g) if act == "silu" else F.gelu(g)
    return (g * (x @ w_up)) @ w_down


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """[d_head//2] inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def rope_tables(positions: torch.Tensor, d_head: int, theta: float):
    """(cos, sin), each [B, T, 1, d_head/2] float32, for positions [B, T].
    The stack computes them once per forward and every layer reuses them
    (the reference recomputes them per layer and lets XLA fold that)."""
    inv = rope_freqs(d_head, theta, device=positions.device)
    ang = positions[..., None].float() * inv                  # [B, T, dh/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Rotate-half RoPE of x [B, T, H, Dh] with precomputed tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x [B, T, H, Dh], positions [B, T] -> rotated x (rotate-half form)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def mrope_tables(positions: torch.Tensor, d_head: int, theta: float,
                 sections) -> tuple:
    """(cos, sin), each [B, T, 1, d_head/2] float32, for M-RoPE positions
    [3, B, T] (Qwen2-VL §3.1): the frequency bands are cut into
    (temporal, height, width) ``sections``, and band ``i`` turns by the
    position stream of its section. For text the three streams are equal
    and the tables are ``rope_tables``'."""
    half = d_head // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"d_head/2 = {half}")
    inv = rope_freqs(d_head, theta, device=positions.device)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=positions.device),
        torch.tensor(sections, device=positions.device))      # [half]
    pos = positions.float()[sec_id]                           # [half, B, T]
    ang = pos.movedim(0, -1) * inv                            # [B, T, half]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """x [B, T, H, Dh], positions [3, B, T] -> rotated x."""
    return rotate(x, *mrope_tables(positions, x.shape[-1], theta, sections))


def position_tables(positions: torch.Tensor, cfg, d_head: int):
    """The rotation tables of ``cfg.rope_mode`` for ``positions``, which
    every layer shares: ``rope_tables`` of [B, T], ``mrope_tables`` of
    [3, B, T] (a [B, T] input broadcasts to three equal streams), None
    for ``"none"``."""
    if cfg.rope_mode == "none":
        return None
    if cfg.rope_mode == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand((3,) + positions.shape)
        return mrope_tables(positions, d_head, cfg.rope_theta,
                            cfg.mrope_sections)
    if cfg.rope_mode != "rope":
        raise NotImplementedError(f"rope_mode={cfg.rope_mode!r}")
    return rope_tables(positions, d_head, cfg.rope_theta)


def positional_rotate(x: torch.Tensor, positions: torch.Tensor, cfg,
                      tables=None) -> torch.Tensor:
    """Dispatch on ``cfg.rope_mode`` (``"rope"``, ``"mrope"`` or
    ``"none"``); positions are [B, T], or [3, B, T] under M-RoPE.
    ``tables`` are ``position_tables`` of ``positions`` when the caller
    has them."""
    if tables is None:
        tables = position_tables(positions, cfg, x.shape[-1])
    return x if tables is None else rotate(x, *tables)
