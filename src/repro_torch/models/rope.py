"""Rotary position embeddings (the reference's ``models/rope.py``; M-RoPE
waits for the VLM slice, ROADMAP Queue 1 item 10)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    # x: (..., head_dim); rotate-half convention
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, n_heads, head_dim), positions (B, S) int."""
    if theta <= 0:  # arch without RoPE
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def default_positions(batch: int, seq: int, offset=0,
                      device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
