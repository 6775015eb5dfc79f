"""The paper's evaluation workload (Sec. VI-A): the job distribution and the
market regime of Fig. 9/10. Copied from the JAX package's
``benchmarks/common.py``, which imports the reference package."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.fast_sim import JobArrays
from repro_torch.core.market import Trace, vast_like_trace

# LLaMA2-7B LoRA job, 30-min slots, workload 80 over deadline 10,
# N in [1, 12], mu = 0.9
PAPER_JOB = JobConfig(workload=80.0, deadline=10, n_min=1, n_max=12,
                      value=120.0, gamma=2.0, on_demand_price=1.0)
PAPER_TPUT = ThroughputConfig(alpha=1.0, beta=0.0, mu1=0.9, mu2=0.95)


def job_stream_arrays(rng: np.random.Generator, n: int, deadline: int = 10,
                      workload_scale: float = 1.0) -> JobArrays:
    """Fig. 9 job distribution as stacked JobArrays with numpy leaves — one
    vectorized rng call per field. L ~ U[70,120], Nmin in [1,4),
    Nmax in [12,17); value/gamma/on-demand price from the paper job.
    ``workload_scale`` multiplies the drawn workloads in f64 before the f32
    cast (1.0 is a bitwise no-op)."""
    cfg = JobConfig(deadline=deadline, value=PAPER_JOB.value)
    return JobArrays(
        workload=(rng.uniform(70, 120, n) * workload_scale).astype(np.float32),
        deadline=np.full(n, cfg.deadline, np.int32),
        n_min=rng.integers(1, 4, n).astype(np.int32),
        n_max=rng.integers(12, 17, n).astype(np.int32),
        value=np.full(n, cfg.value, np.float32),
        gamma=np.full(n, cfg.gamma, np.float32),
        p_o=np.full(n, cfg.on_demand_price, np.float32),
    )


def paper_market(seed: int = 11, days: float = 30, **overrides) -> Trace:
    """The evaluation market regime: scarce availability with a strong
    diurnal cycle and volatile prices that regularly approach the on-demand
    rate — the conditions under which prediction pays (paper Sec. VI)."""
    kw = dict(mean_price=0.7, price_sigma=0.5, avail_mean=5.5,
              avail_season_amp=3.0)
    kw.update(overrides)
    return vast_like_trace(seed=seed, days=days, **kw)
