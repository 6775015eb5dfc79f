"""GQA attention: full / causal / sliding-window, forward, prefill and
decode paths (the reference's ``models/attention.py``).

Every full-sequence attention goes to ``ops.attention`` (K3 on the card).
It masks by the tokens' positions, as the reference does: ``None`` stands
for positions counted from 0 (K3's index path, which skips masked tiles),
a vector for a batch's own (Qwen2-VL's M-RoPE temporal stream, where an
image span shares one position). The reference's blockwise XLA path has
no counterpart here; K3 is the blockwise path. One-token decode against
the ring-buffer KV cache (``decode_attend``) stays in torch ops, as the
reference computes it in plain XLA.

The port updates the KV cache in place (``write_prefill``,
``write_decode``) where the reference returns new arrays: at llama2-7b's
serving size the cache is 8.6 GB.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import MASK_FILL
from repro_torch.models import lora as lora_lib
from repro_torch.models.common import normal_param
from repro_torch.models.rope import apply_m_rope, apply_rope


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def lora_shapes(cfg) -> dict:
    """(in_dim, out_shape) of each attention adapter target."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"q": (d, (h, hd)), "k": (d, (kv, hd)), "v": (d, (kv, hd)),
            "o": (h * hd, (d,))}


def init_attention(generator: torch.Generator, cfg, dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    p = {
        "wq": normal_param(generator, (d, h, hd), dtype),
        "wk": normal_param(generator, (d, kv, hd), dtype),
        "wv": normal_param(generator, (d, kv, hd), dtype),
        "wo": normal_param(generator, (h, hd, d), dtype,
                           stddev=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
    if cfg.o_bias:
        p["bo"] = torch.zeros((d,), dtype=dtype, device=dev)
    lora_tree = {t: lora_lib.init_lora_pair(generator, in_dim, out_shape,
                                            cfg.lora.rank)
                 for t, (in_dim, out_shape) in lora_shapes(cfg).items()
                 if t in cfg.lora.targets}
    if lora_tree:
        p["lora"] = lora_tree
    return p


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def qkv_project(cfg, p, x, positions, kcfg: ops.KernelConfig = ops.DEFAULT):
    """x:(B,S,d) -> q:(B,S,h,hd), k,v:(B,S,kv,hd), with RoPE applied."""
    scale = cfg.lora.alpha / cfg.lora.rank
    lt = p.get("lora", {})
    q = lora_lib.proj(x, p["wq"], p.get("bq"), lt.get("q"), scale, kcfg)
    k = lora_lib.proj(x, p["wk"], p.get("bk"), lt.get("k"), scale, kcfg)
    v = lora_lib.proj(x, p["wv"], p.get("bv"), lt.get("v"), scale, kcfg)
    if cfg.m_rope:
        q = apply_m_rope(q, positions, cfg.rope_theta, cfg.m_rope_sections)
        k = apply_m_rope(k, positions, cfg.rope_theta, cfg.m_rope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(cfg, p, attn_out, kcfg: ops.KernelConfig = ops.DEFAULT):
    """attn_out:(B,S,h,hd) -> (B,S,d)."""
    scale = cfg.lora.alpha / cfg.lora.rank
    b, s, n, hd = attn_out.shape
    return lora_lib.proj(attn_out.reshape(b, s, n * hd),
                         p["wo"].reshape(n * hd, -1), p.get("bo"),
                         p.get("lora", {}).get("o"), scale, kcfg)


# ---------------------------------------------------------------------------
# Full-sequence attention
# ---------------------------------------------------------------------------

def attend(q, k, v, q_pos: Optional[torch.Tensor],
           k_pos: Optional[torch.Tensor], causal: bool,
           window: Optional[int], kcfg: ops.KernelConfig = ops.DEFAULT):
    """q (B,Sq,h,hd), k / v (B,Sk,kv,hd), q_pos (Sq,) / k_pos (Sk,) int32
    or None for positions from 0 -> (B,Sq,h,hd)."""
    return ops.attention(q, k, v, causal=causal, window=window, q_pos=q_pos,
                         k_pos=k_pos, kcfg=kcfg)


# ---------------------------------------------------------------------------
# KV cache (full + sliding-window ring buffer)
# ---------------------------------------------------------------------------

def cache_width(cfg, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_kv_cache(cfg, batch: int, max_len: int, dtype, n_layers: int,
                  device) -> dict:
    shape = (n_layers, batch, cache_width(cfg, max_len), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_prefill(cfg, cache_k, cache_v, k, v):
    """Write a full prefix (B,S,kv,hd) into one layer's cache (B,W,kv,hd), in
    place; returns the cache."""
    w = cache_k.shape[1]
    s = k.shape[1]
    if s >= w:
        shift = s % w
        cache_k.copy_(torch.roll(k[:, -w:], shift, dims=1))
        cache_v.copy_(torch.roll(v[:, -w:], shift, dims=1))
    else:
        cache_k[:, :s] = k
        cache_v[:, :s] = v
    return cache_k, cache_v


def write_decode(cache_k, cache_v, k1, v1, index: int):
    """Write one token (B,1,kv,hd) at ring slot index % W, in place."""
    slot = index % cache_k.shape[1]
    cache_k[:, slot] = k1[:, 0]
    cache_v[:, slot] = v1[:, 0]
    return cache_k, cache_v


def ring_positions(width: int, index: int, device=None) -> torch.Tensor:
    """Position held by each ring slot after `index` tokens written; -1 = empty.

    Slot j holds the largest position p < index with p % width == j
    (``torch.remainder`` floors, as the reference's ``%`` does)."""
    j = torch.arange(width, dtype=torch.int32, device=device)
    last = index - 1
    p = last - torch.remainder(last - j, width)
    if index <= 0:
        return torch.full_like(p, -1)
    return torch.where(p >= 0, p, -1)


def decode_attend(cfg, q1, cache_k, cache_v, index: int):
    """q1:(B,1,h,hd) against one layer's ring cache; returns (B,1,h,hd)."""
    b, _, h, hd = q1.shape
    w = cache_k.shape[1]
    k_pos = ring_positions(w, index, q1.device)
    kvh = cache_k.shape[2]
    rep = h // kvh
    qf = q1.float().reshape(b, 1, kvh, rep, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqkrh,bskh->bkrqs", qf, cache_k.float())
    ok = k_pos >= 0
    if cfg.sliding_window is not None:
        # the query's position is index-1 (index counts the current token)
        ok &= k_pos > index - 1 - cfg.sliding_window
    s = s.masked_fill(~ok, MASK_FILL)
    wgt = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrqs,bskh->bqkrh", wgt, cache_v.float())
    return out.reshape(b, 1, h, hd).to(q1.dtype)
