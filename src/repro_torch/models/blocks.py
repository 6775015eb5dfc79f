"""Decoder blocks: the pre-norm transformer block (a dense MLP or a MoE
layer after attention) and the Mamba2 residual block, full-sequence and
one-token decode variants (the reference's ``models/blocks.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.sharding import shard


def init_transformer_block(generator: torch.Generator, cfg, dtype) -> dict:
    """A MoE layer after attention for the moe family, a dense MLP
    otherwise (the hybrid family's shared block included). Param
    leaves."""
    p = {
        "attn_norm": init_norm(cfg, dtype, generator.device),
        "attn": attn.init_attention(generator, cfg, dtype),
        "mlp_norm": init_norm(cfg, dtype, generator.device),
    }
    if cfg.arch_type == "moe":
        p["moe"] = moe_lib.init_moe(generator, cfg, dtype)
    else:
        p["mlp"] = init_mlp(generator, cfg, dtype)
    return p


def _ffn(cfg, p, x, kcfg):
    """The block's feed-forward half: (y, aux loss; 0 for a dense MLP)."""
    if "moe" in p:
        return moe_lib.apply_moe(cfg, p["moe"], x)
    return (apply_mlp(cfg, p["mlp"], x, kcfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def mask_positions(cfg, positions) -> torch.Tensor:
    """The (S,) int32 positions that mask attention, as the reference takes
    them: batch row 0's temporal stream under M-RoPE, else row 0."""
    q_pos = positions[..., 0][0] if cfg.m_rope else positions[0]
    return q_pos.to(torch.int32).contiguous()


def transformer_block_full(cfg, p, h, positions, q_pos=None,
                           want_cache: bool = False,
                           kcfg: ops.KernelConfig = ops.DEFAULT):
    """Full sequence (forward / prefill). ``positions`` rotate q and k;
    ``q_pos`` (:func:`mask_positions`) masks attention, as query and key
    positions both, or is None when the positions are the default ones
    counted from 0 (K3's index path).

    Returns (h, aux_loss) or, when ``want_cache``, (h, aux_loss, (k, v))."""
    x = apply_norm(cfg, p["attn_norm"], h)
    q, k, v = attn.qkv_project(cfg, p["attn"], x, positions, kcfg)
    out = attn.attend(q, k, v, q_pos, q_pos, causal=cfg.causal,
                      window=cfg.sliding_window, kcfg=kcfg)
    h = h + attn.out_project(cfg, p["attn"], out, kcfg)
    h = shard(h, "batch", "seq", "embed")
    x = apply_norm(cfg, p["mlp_norm"], h)
    y, aux = _ffn(cfg, p, x, kcfg)
    h = h + y
    h = shard(h, "batch", "seq", "embed")
    if want_cache:
        return h, aux, (k, v)
    return h, aux


def transformer_block_decode(cfg, p, h1, cache_k, cache_v, index: int,
                             positions, kcfg: ops.KernelConfig = ops.DEFAULT):
    """One-token decode. h1:(B,1,d); writes this layer's cache in place."""
    x = apply_norm(cfg, p["attn_norm"], h1)
    q, k, v = attn.qkv_project(cfg, p["attn"], x, positions, kcfg)
    attn.write_decode(cache_k, cache_v, k, v, index)
    out = attn.decode_attend(cfg, q, cache_k, cache_v, index + 1)
    h1 = h1 + attn.out_project(cfg, p["attn"], out, kcfg)
    x = apply_norm(cfg, p["mlp_norm"], h1)
    return h1 + _ffn(cfg, p, x, kcfg)[0]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def init_mamba_block(generator: torch.Generator, cfg, dtype) -> dict:
    return {
        "norm": init_norm(cfg, dtype, generator.device),
        "mamba": ssm_lib.init_mamba(generator, cfg, dtype),
    }


def mamba_block_full(cfg, p, h, return_cache: bool = False,
                     kcfg: ops.KernelConfig = ops.DEFAULT):
    """Full sequence. Returns h or, when ``return_cache``, (h, mamba cache)."""
    x = apply_norm(cfg, p["norm"], h)
    if return_cache:
        y, cache = ssm_lib.apply_mamba(cfg, p["mamba"], x, return_cache=True,
                                       kcfg=kcfg)
        return h + y, cache
    h = h + ssm_lib.apply_mamba(cfg, p["mamba"], x, kcfg=kcfg)
    return shard(h, "batch", "seq", "embed")


def mamba_block_decode(cfg, p, h1, cache, kcfg: ops.KernelConfig = ops.DEFAULT):
    """One-token decode. h1:(B,1,d) -> (h1, new mamba cache)."""
    x = apply_norm(cfg, p["norm"], h1)
    y, new_cache = ssm_lib.apply_mamba_decode(cfg, p["mamba"], x, cache, kcfg)
    return h1 + y, new_cache
