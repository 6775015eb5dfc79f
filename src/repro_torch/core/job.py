"""Fine-tuning job model in torch: the deadline value function V(T) (Eq. 4)
and its reformulation Ṽ(Z^ddl) (Eq. 9), plus the EG selector's per-job
utility normalization (one job, or a stacked batch). Port of the JAX
package's ``core/job.py``.

Ṽ absorbs the *termination configuration*: any workload left at the deadline
is finished immediately with N^max on-demand instances, so the value and the
post-deadline cost become functions of Z^ddl only (Sec. III-E.2).

Job fields may be python scalars (one shared job) or tensors that broadcast
against the progress argument (one job per row). Python-scalar
subexpressions are evaluated in python, as the reference's weakly typed
scalars are, and every tensor op runs in f32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import JobConfig, ThroughputConfig


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as an f32 tensor on ``like``'s device (a no-op for tensors)."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: minimum(maximum(x, lo), hi); lo/hi scalars or tensors."""
    return torch.minimum(torch.maximum(x, _f32(lo, x)), _f32(hi, x))


def exact_div(x: torch.Tensor, y) -> torch.Tensor:
    """``x / y`` rounded once, on the card as on the CPU and in the
    reference. PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's reciprocal (two roundings), so a Python ``y`` becomes a 0-dim
    tensor of ``x``'s dtype on ``x``'s device first (a fill, no copy)."""
    if not torch.is_tensor(y):
        y = torch.full((), y, dtype=x.dtype, device=x.device)
    return x / y


def expected_progress(job: JobConfig, t):
    """Uniform workload slicing Z^exp_t = (L/d) * t (Eq. 6)."""
    return job.workload / job.deadline * t


def value_fn(job: JobConfig, T):
    """V(T), Eq. 4: full value v until d, linear decay to 0 at gamma*d."""
    v, d, g = job.value, job.deadline, job.gamma
    T = torch.as_tensor(T).to(torch.float32)
    decay = v * (1.0 - exact_div(T - d, (g - 1.0) * d))
    return torch.where(T <= d, _f32(v, T), _clip(decay, 0.0, v))


def termination_time(job: JobConfig, tput: ThroughputConfig, z_ddl):
    """Extra (fractional) slots past d to finish L - Z^ddl with N^max
    on-demand."""
    rate = tput.alpha * job.n_max + tput.beta
    z = torch.as_tensor(z_ddl).to(torch.float32)
    remaining = torch.clamp_min(job.workload - z, 0.0)
    return exact_div(remaining, rate)


def tilde_value(job: JobConfig, tput: ThroughputConfig, z_ddl):
    """Ṽ(Z^ddl), Eq. 9: value at completion minus post-deadline on-demand
    cost. Piecewise-linear in Z^ddl and NOT concave, which is why the
    window solver evaluates every prefix length (see window_opt)."""
    dt = termination_time(job, tput, z_ddl)
    val = value_fn(job, job.deadline + dt)
    post_cost = job.on_demand_price * job.n_max * dt
    return val - post_cost


def normalization_bounds(job: JobConfig):
    """(u_min, u_max) for the EG selector's normalized utility (Thm. 2 needs
    u in [0,1]). u_max = v; u_min = worst feasible spend with zero value."""
    u_max = job.value
    u_min = -job.on_demand_price * job.n_max * job.gamma * job.deadline
    return u_min, u_max


def normalize_utility(job: JobConfig, u) -> torch.Tensor:
    """One job's utilities mapped to [0, 1], as an f32 tensor. The
    arithmetic runs in ``u``'s own float dtype, as the reference's runs in
    numpy's before its clip casts to f32."""
    lo, hi = normalization_bounds(job)
    u = torch.as_tensor(u)
    if not u.is_floating_point():
        u = u.to(torch.float32)
    return torch.clamp(exact_div(u - lo, hi - lo), 0.0, 1.0).to(
        torch.float32)


def normalization_bounds_batch(jobs):
    """Per-job (u_min, u_max) bounds of the EG selector's [0, 1] utility:
    ``jobs`` carries stacked (K,) tensor leaves (fast_sim.JobArrays).
    u_max = v; u_min = worst feasible spend with zero value."""
    f = lambda x: x.to(torch.float32)
    u_max = f(jobs.value)
    u_min = -(f(jobs.p_o) * f(jobs.n_max) * f(jobs.gamma) * f(jobs.deadline))
    return u_min, u_max


def normalize_utility_batch(jobs, u: torch.Tensor) -> torch.Tensor:
    """Map the (K, M) raw-utility matrix through the per-job [0, 1]
    normalization (Thm. 2's precondition)."""
    lo, hi = normalization_bounds_batch(jobs)
    return torch.clamp((u - lo[:, None]) / (hi - lo)[:, None], 0.0, 1.0)
