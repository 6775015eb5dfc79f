"""Offline optimal (hindsight) solution of the full problem (Eq. 5) by DP,
copied from the JAX package's ``core/offline_opt.py``: float64 numpy, with
Ṽ from the port's ``job.tilde_value`` (f32, as the reference's).

State: (slot t, previous instance count n_prev, workload bin z). Exact up to
the workload discretization (bins of ``gran`` * alpha units; mu in {mu1, mu2,
1} makes progress non-integer). Per-slot action = total instance count n in
{0} u [Nmin, Nmax]; the spot/on-demand split is greedily optimal given n
(spot iff p^s <= p^o, capped by availability). Used for:
  * the paper Fig. 4-style OPT column,
  * Theorem 1 empirical gap U(OPT) - U(AHAP) (benchmarks/theorem1),
  * sanity upper bound in property tests (no policy may beat OPT).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.job import tilde_value
from repro_torch.core.market import Trace


@dataclass
class OfflineResult:
    utility: float
    plan_total: np.ndarray   # (d,) total instances per slot
    plan_spot: np.ndarray    # (d,)
    plan_od: np.ndarray      # (d,)
    cost: float
    z_ddl: float


def solve_offline(
    job: JobConfig,
    tput: ThroughputConfig,
    trace: Trace,
    gran: float = 0.25,
) -> OfflineResult:
    d = job.deadline
    prices = np.asarray(trace.prices[:d], float)
    avail = np.asarray(trace.avail[:d], int)
    p_o = job.on_demand_price

    actions = np.array([0] + list(range(job.n_min, job.n_max + 1)))
    n_actions = len(actions)
    zmax = job.workload  # progress beyond L is worthless
    dz = gran * tput.alpha
    nz = int(np.floor(zmax / dz)) + 1
    n_prev_states = job.n_max + 1

    # value[n_prev, zbin] = max over remaining slots of (future utility)
    # terminal: tilde_value(z) (cost already subtracted along the way)
    zgrid = np.minimum(np.arange(nz) * dz, zmax)
    term = np.asarray(tilde_value(job, tput, zgrid))  # (nz,)
    value = np.tile(term[None, :], (n_prev_states, 1))
    # choice[t, n_prev, zbin] -> action index
    choice = np.zeros((d, n_prev_states, nz), np.int32)

    n_prev_grid = np.arange(n_prev_states)[:, None, None]      # (P,1,1)
    act = actions[None, :, None]                               # (1,A,1)

    h = np.where(act > 0, tput.alpha * act + tput.beta, 0.0)   # (1,A,1)
    mu = np.where(
        act > n_prev_grid, tput.mu1, np.where(act < n_prev_grid, tput.mu2, 1.0)
    )
    mu = np.where((act == 0) & (n_prev_grid == 0), 1.0, mu)    # (P,A,1)

    for t in range(d - 1, -1, -1):
        ns = np.minimum(actions, avail[t]) if prices[t] <= p_o else np.zeros_like(actions)
        no = actions - ns
        cost = ns * prices[t] + no * p_o                        # (A,)
        dzt = mu * h                                            # (P,A,1)
        znew = zgrid[None, None, :] + dzt                       # (P,A,nz)
        zbin_new = np.minimum((znew / dz).astype(np.int64), nz - 1)
        # future value: V_{t+1}[n_now, zbin_new]
        fut = value[actions[None, :, None], zbin_new]           # broadcast (P,A,nz)
        q = fut - cost[None, :, None]
        best = q.argmax(axis=1)                                 # (P, nz)
        choice[t] = best
        value = np.take_along_axis(q, best[:, None, :], axis=1)[:, 0, :]

    # roll forward to extract the plan
    z, n_prev, zbin = 0.0, 0, 0
    tot, spot, od = [], [], []
    cost_acc = 0.0
    for t in range(d):
        a = choice[t, n_prev, zbin]
        n = int(actions[a])
        ns = min(n, int(avail[t])) if prices[t] <= p_o else 0
        no = n - ns
        m = 1.0 if n == n_prev else (tput.mu1 if n > n_prev else tput.mu2)
        if n == 0 and n_prev == 0:
            m = 1.0
        z = min(z + m * (tput.alpha * n + (tput.beta if n > 0 else 0.0)), zmax)
        cost_acc += ns * prices[t] + no * p_o
        tot.append(n)
        spot.append(ns)
        od.append(no)
        n_prev = n
        zbin = min(int(z / dz), nz - 1)
    util = float(tilde_value(job, tput, z)) - cost_acc
    return OfflineResult(
        utility=util,
        plan_total=np.array(tot),
        plan_spot=np.array(spot),
        plan_od=np.array(od),
        cost=cost_acc,
        z_ddl=float(z),
    )
