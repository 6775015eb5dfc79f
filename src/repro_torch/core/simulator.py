"""Slot-level execution of a policy on a market trace (reference simulator),
copied from the JAX package's ``core/simulator.py``: the python oracle the
port's vectorized pool simulator is held against.

Semantics (Sec. III): instances are billed per whole slot; progress in a slot
is mu_t * H(n_t) (Eq. 1-2); the job stops renting once Z >= L; workload left
at the deadline is finished by the termination configuration (N^max
on-demand, fractionally billed) which is exactly the Ṽ(Z^ddl) - C^ddl
objective (Eq. 9). Completion time is fractional within the finishing slot so
V(T) is evaluated on continuous T (Eq. 4).

The vectorized twin of this loop lives in fast_sim.py;
tests/test_torch_policies.py pins them against each other.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.job import value_fn
from repro_torch.core.market import Trace
from repro_torch.core.policies import BasePolicy, Obs


@dataclass
class SimResult:
    utility: float
    value: float
    cost: float
    completion_time: float      # slots (may exceed d via termination config)
    z_ddl: float
    completed_by_deadline: bool
    n_total: np.ndarray
    n_spot: np.ndarray
    n_od: np.ndarray

    @property
    def workload_done(self) -> float:
        return self.z_ddl


def exec_slot(job: JobConfig, tput: ThroughputConfig, z: float, n_prev: int,
              t: int, n_o: int, n_s: int, price: float, avail: int):
    """One slot of the paper's execution semantics, shared by this loop and
    the regional reference (region_market.simulate_regional): hard
    feasibility clip (5b)-(5d), mu reconfiguration ramp, whole-slot billing,
    fractional completion. Returns (n_o, n_s, work, cost_delta,
    t_complete-or-None)."""
    n_s = int(np.clip(n_s, 0, min(avail, job.n_max)))
    n_o = int(np.clip(n_o, 0, job.n_max - n_s))
    n = n_o + n_s
    if 0 < n < job.n_min:
        n_o += job.n_min - n
        n = n_o + n_s

    mu = 1.0 if n == n_prev else (tput.mu1 if n > n_prev else tput.mu2)
    if n == 0 and n_prev == 0:
        mu = 1.0
    work = mu * (tput.alpha * n + (tput.beta if n > 0 else 0.0))
    cost_delta = n_s * price + n_o * job.on_demand_price  # whole-slot billing

    t_complete = None
    if work > 0 and z + work >= job.workload:
        t_complete = t + (job.workload - z) / work
    return n_o, n_s, work, cost_delta, t_complete


def termination_config(job: JobConfig, tput: ThroughputConfig, z: float):
    """Finish the leftover workload with N^max on-demand past the deadline
    (fractionally billed, Eq. 9). Returns (extra_slots, extra_cost)."""
    h_max = tput.alpha * job.n_max + tput.beta
    dt = (job.workload - z) / h_max
    return dt, job.on_demand_price * job.n_max * dt


def simulate(
    policy: BasePolicy,
    job: JobConfig,
    tput: ThroughputConfig,
    trace: Trace,
    pred_matrix: Optional[np.ndarray] = None,  # (T, horizon+1, 2)
) -> SimResult:
    d = job.deadline
    assert len(trace) >= d, "trace shorter than deadline"
    policy.reset(job, tput)

    z, n_prev, cost = 0.0, 0, 0.0
    T_complete: Optional[float] = None
    ns_hist, no_hist = np.zeros(d, int), np.zeros(d, int)

    for t in range(d):
        price, avail = float(trace.prices[t]), int(trace.avail[t])
        pred = pred_matrix[t] if pred_matrix is not None else None
        obs = Obs(t=t, price=price, avail=avail, z_prev=z, n_prev=n_prev, pred=pred)
        n_o, n_s = policy.decide(obs)
        # hard feasibility (5b)-(5d): never trust a policy blindly
        n_o, n_s, work, dc, T_complete = exec_slot(
            job, tput, z, n_prev, t, n_o, n_s, price, avail
        )
        cost += dc
        ns_hist[t], no_hist[t] = n_s, n_o
        z = min(z + work, job.workload)
        n_prev = n_o + n_s
        if T_complete is not None:
            break

    if T_complete is not None:
        value = float(value_fn(job, T_complete))
    else:
        # termination configuration: N^max on-demand past the deadline
        dt, dc = termination_config(job, tput, z)
        T_complete = d + dt
        cost += dc
        value = float(value_fn(job, T_complete))

    return SimResult(
        utility=value - cost,
        value=value,
        cost=cost,
        completion_time=float(T_complete),
        z_ddl=float(z),
        completed_by_deadline=T_complete <= d,
        n_total=ns_hist + no_hist,
        n_spot=ns_hist,
        n_od=no_hist,
    )
