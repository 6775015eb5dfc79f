"""Throughput and reconfiguration model (Eqs. 1-2) in torch.

H(n) = alpha*n + beta for n>0 (paper Fig. 1: near-linear multi-GPU LoRA
scaling); mu_t in {mu1, mu2, 1} charges scale-up/scale-down overhead as a
lost fraction of the slot. Port of the JAX package's ``core/throughput.py``
(``calibrate`` and ``tokens_per_slot`` belong to the training slice and are
not ported yet). Integer counts come out as f32 rates, as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ThroughputConfig


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
