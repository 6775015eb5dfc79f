"""Scheduling configs: the job four-tuple and the throughput model."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class JobConfig:
    """The paper's four-tuple {L, d, N^min, N^max} plus value-function params.

    Fields may also hold (B,) tensors: the batched window solver builds one
    per-row JobConfig over a whole lane batch."""

    workload: float = 80.0          # L
    deadline: int = 10              # d (slots)
    n_min: int = 1
    n_max: int = 12
    value: float = 40.0             # v
    gamma: float = 2.0              # hard deadline = gamma * d
    on_demand_price: float = 1.0    # p^o per instance-slot


@dataclass(frozen=True)
class ThroughputConfig:
    alpha: float = 1.0              # H(n) = alpha*n + beta (n>0)
    beta: float = 0.0
    mu1: float = 0.9                # scale-up effective fraction
    mu2: float = 0.95               # scale-down effective fraction
