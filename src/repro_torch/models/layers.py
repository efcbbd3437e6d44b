"""Primitive layers (twin of ``repro.models.layers``): RMSNorm, the gated
MLP, rotary position embeddings."""
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


def positional_rotate(x: torch.Tensor, positions: torch.Tensor, cfg,
                      tables=None) -> torch.Tensor:
    """Dispatch on ``cfg.rope_mode`` (``"rope"`` or ``"none"``; M-RoPE
    comes with the model families that use it). ``tables`` are
    ``rope_tables`` of ``positions`` when the caller has them."""
    if cfg.rope_mode == "none":
        return x
    if cfg.rope_mode != "rope":
        raise NotImplementedError(f"rope_mode={cfg.rope_mode!r}")
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], cfg.rope_theta)
    return rotate(x, *tables)
