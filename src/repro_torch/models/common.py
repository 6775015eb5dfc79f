"""Shared building blocks: initializers, norms, activations (the
reference's ``models/common.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def normal_param(generator: torch.Generator, shape, dtype,
                 stddev: Optional[float] = None) -> torch.Tensor:
    """A normal draw in f32 on the generator's device, scaled and then cast
    (fan-in scaling ``1/sqrt(shape[0])`` by default, as the reference)."""
    if stddev is None:
        stddev = 1.0 / math.sqrt(shape[0])
    v = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (v * stddev).to(dtype)


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dtype)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def init_norm(cfg, dtype, device) -> dict:
    """Norm params per config.norm_type. layernorm_np (OLMo) has no params."""
    d = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm_np":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, params["scale"], cfg.norm_eps)
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    if cfg.norm_type == "layernorm_np":
        return layernorm(x, None, None, cfg.norm_eps)
    raise ValueError(cfg.norm_type)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]
