"""Shared building blocks: initializers, norms, activations (the
reference's ``models/common.py``). The initializers return
:class:`repro_torch.sharding.Param` leaves: the value and its logical
axes."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import Param


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def normal_param(generator: torch.Generator, shape, axes, dtype,
                 stddev: Optional[float] = None) -> Param:
    """A normal draw in f32 on the generator's device, scaled and then cast
    (fan-in scaling ``1/sqrt(shape[0])`` by default, as the reference)."""
    if stddev is None:
        stddev = 1.0 / math.sqrt(shape[0])
    v = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return Param((v * stddev).to(dtype), axes)


def zeros_param(shape, axes, dtype, device) -> Param:
    return Param(torch.zeros(tuple(shape), dtype=dtype, device=device), axes)


def ones_param(shape, axes, dtype, device) -> Param:
    return Param(torch.ones(tuple(shape), dtype=dtype, device=device), axes)


def const_param(value: torch.Tensor, axes) -> Param:
    return Param(value, axes)


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
        return {"scale": ones_param((d,), (None,), dtype, device)}
    if cfg.norm_type == "layernorm":
        return {"scale": ones_param((d,), (None,), dtype, device),
                "bias": zeros_param((d,), (None,), dtype, device)}
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
