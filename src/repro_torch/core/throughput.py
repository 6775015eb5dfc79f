"""Throughput and reconfiguration model (Eqs. 1-2) in torch.

H(n) = alpha*n + beta for n>0 (paper Fig. 1: near-linear multi-GPU LoRA
scaling); mu_t in {mu1, mu2, 1} charges scale-up/scale-down overhead as a
lost fraction of the slot. Port of the JAX package's ``core/throughput.py``.
Integer counts come out as f32 rates, as in the reference. ``calibrate``
derives (alpha, mu) for an architecture from its checkpoint size, rounded
through f32 as the reference's are; its defaults are the reference's (a
TPU v5e's 197 TFLOP/s), and a caller that wants another card's figures
passes them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ThroughputConfig


def throughput(tput: ThroughputConfig, n):
    """H(n): alpha*n + beta for n > 0, else 0."""
    n = torch.as_tensor(n)
    h = tput.alpha * n + tput.beta
    return torch.where(n > 0, h, 0.0)


def mu_factor(tput: ThroughputConfig, n_prev, n_now):
    """Eq. 2: mu1 on scale-up (new instances boot + reshard), mu2 on
    scale-down (reshard only), 1 when unchanged."""
    n_prev, n_now = torch.as_tensor(n_prev), torch.as_tensor(n_now)
    up = torch.tensor(tput.mu1, dtype=torch.float32, device=n_now.device)
    down = torch.tensor(tput.mu2, dtype=torch.float32, device=n_now.device)
    out = torch.where(n_now > n_prev, up,
                      torch.where(n_now < n_prev, down, 1.0))
    # no reconfiguration cost when nothing was or is running
    return torch.where((n_prev == 0) & (n_now == 0), 1.0, out)


def effective_work(tput: ThroughputConfig, n_prev, n_now):
    """mu_t * H(n_t): workload completed in one slot."""
    return mu_factor(tput, n_prev, n_now) * throughput(tput, n_now)


def _clip01_f32(x: float) -> float:
    """``float(jnp.clip(x, 0.0, 1.0))`` with x64 off: x rounded to f32."""
    return float(np.clip(np.float32(x), np.float32(0.0), np.float32(1.0)))


def calibrate(
    cfg: ModelConfig,
    *,
    slot_seconds: float = 1800.0,
    bandwidth_bps: float = 800e6,
    chip_flops: float = 197e12,
    mfu: float = 0.4,
    startup_seconds: float = 180.0,
) -> ThroughputConfig:
    """Arch-aware (alpha, mu1, mu2).

    alpha: workload-units/slot per instance. With the paper's convention
    "unit GPU compute power = 1" alpha is 1 by definition; the tokens/slot
    rate is ``tokens_per_slot``. mu1 folds checkpoint transfer + startup;
    mu2 transfer only (scale-down needs no boot)."""
    from repro_torch.checkpoint.ckpt import transfer_seconds

    xfer = transfer_seconds(cfg, bandwidth_bps)
    mu1 = _clip01_f32(1.0 - (xfer + startup_seconds) / slot_seconds)
    mu2 = _clip01_f32(1.0 - xfer / slot_seconds)
    return ThroughputConfig(alpha=1.0, beta=0.0, mu1=mu1, mu2=mu2)


def tokens_per_slot(
    cfg: ModelConfig, *, slot_seconds: float = 1800.0,
    chip_flops: float = 197e12, mfu: float = 0.4,
) -> float:
    """Tokens one instance fine-tunes per slot (3x forward FLOPs for LoRA
    training: forward + recompute + activation-gradient backward; no base
    weight gradients)."""
    per_token = 3.0 * cfg.flops_per_token()
    return chip_flops * mfu * slot_seconds / per_token
