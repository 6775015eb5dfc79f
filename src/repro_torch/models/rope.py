"""Rotary position embeddings, including Qwen2-VL M-RoPE (the reference's
``models/rope.py``).

M-RoPE splits the rotary frequency dimensions into (temporal, height, width)
sections, each rotated by its own position stream. For text tokens all three
streams carry the same position, which makes M-RoPE coincide with RoPE."""
from __future__ import annotations

import torch

from repro_torch.obs import ranges


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


@ranges.stage(ranges.ROPE)
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


@ranges.stage(ranges.ROPE)
def apply_m_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 sections) -> torch.Tensor:
    """x (B, S, n_heads, head_dim), positions (B, S, 3) int: the (t, h, w)
    streams; ``sections`` (t, h, w) sum to head_dim // 2."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang_all = positions[..., None].float() * freqs          # (B, S, 3, half)
    # frequency index i takes the stream of the section it falls in (slices:
    # an index tensor built from the host would cost a copy and a sync)
    bounds = [0]
    for n in sections:
        bounds.append(bounds[-1] + n)
    ang = torch.cat([ang_all[:, :, s, bounds[s]:bounds[s + 1]]
                     for s in range(3)], dim=-1)             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def default_positions(batch: int, seq: int, offset=0,
                      device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset


def default_m_positions(batch: int, seq: int, offset=0,
                        device=None) -> torch.Tensor:
    """(B, S, 3): the text positions in all three streams."""
    p = default_positions(batch, seq, offset, device).expand(batch, seq)
    return torch.stack([p, p, p], dim=-1)
