"""LoRA (Hu et al., ICLR'22) — the paper's fine-tuning method (Sec. II-A);
the reference's ``models/lora.py``.

Base weights stay frozen; each adapted projection W gets a low-rank update
W + (alpha/r) * A @ B with A:(in, r), B:(r, *out). Adapters are kept in f32
and cast to the activation dtype at the call. An adapted projection runs
through ``ops.lora_matmul`` (K2 on the card), which accumulates x @ A in
f32 as the reference's kernel does; the reference's XLA path
(:func:`lora_delta`) takes that product in the model dtype, a stated
difference at bf16 (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import normal_param


def init_lora_pair(generator: torch.Generator, in_dim: int,
                   out_shape: Tuple[int, ...], rank: int) -> dict:
    """A:(in, r) gaussian, B:(r, *out) zeros  (standard LoRA init: AB = 0)."""
    a = normal_param(generator, (in_dim, rank), torch.float32)
    b = torch.zeros((rank,) + tuple(out_shape), dtype=torch.float32,
                    device=generator.device)
    return {"a": a, "b": b}


def lora_delta(x: torch.Tensor, lora: dict, scale: float) -> torch.Tensor:
    """(..., in) -> (..., *out): scale * (x @ A) @ B in the model dtype."""
    a = lora["a"].to(x.dtype)
    b = lora["b"].to(x.dtype)
    xa = x @ a
    y = (xa @ b.reshape(b.shape[0], -1)).reshape(*x.shape[:-1], *b.shape[1:])
    return (scale * y).to(x.dtype)


def proj(x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None, lora: Optional[dict] = None,
         scale: float = 0.0, kcfg: ops.KernelConfig = ops.DEFAULT):
    """y = x @ W (+ LoRA delta) (+ bias). W may be (in, out) or (in, h, hd).

    With an adapter the product is K2's fused x@W + scale*(x@A)@B; the bias
    is added after it (the reference adds it before the delta: f32
    reassociation)."""
    if lora is None:
        y = (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                     *w.shape[1:])
    else:
        y = ops.lora_matmul(x, w, lora["a"].to(x.dtype),
                            lora["b"].to(x.dtype), scale, kcfg)
    if bias is not None:
        y = y + bias
    return y


def merge_lora(w: torch.Tensor, lora: dict, scale: float) -> torch.Tensor:
    """Materialize W + scale*A@B (checkpoint export / serving)."""
    a, b = lora["a"], lora["b"]
    delta = scale * (a @ b.reshape(b.shape[0], -1)).reshape(w.shape)
    return (w.float() + delta).to(w.dtype)
