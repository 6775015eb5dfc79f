"""Multi-job scheduling, the paper's stated extension (Sec. III-A: "our
framework can be readily extended to handle multiple jobs"). Port of the
JAX package's ``core/multi_job.py``.

Jobs arrive over time and COMPETE for the same finite spot pool; each job
runs its own python policy instance, and a priority rule arbitrates the
shared capacity:

  * every live job first *demands* spot against the full slot supply (its
    policy sees the real market, so a solo job matches the reference
    simulator exactly);
  * spot grants then run a least-slack-first waterfall (deadline slack,
    float32, job-id tie-break): the jobs closest to their deadline drain
    the supply first, and each job executes with what it was granted;
  * on-demand is unlimited, so contention only reshapes the cheap-capacity
    split (a job whose grant fell below N^min tops up with on-demand).

This is the host oracle of the fleet engine (``core.fleet``): the slack key
is computed in float32 with the engine's op order, ties break on job id,
and the slot execution repeats the engine's f32 arithmetic, so the two
follow the same progress trajectory. A python AHAP solves its windows
through ``window_opt.solve_window_numpy`` on its own device (K1's table
entry on the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.job import value_fn
from repro_torch.core.market import Trace
from repro_torch.core.policies import BasePolicy, Obs


@dataclass
class ActiveJob:
    job_id: int
    job: JobConfig
    policy: BasePolicy
    arrival: int
    pred: Optional[np.ndarray] = None      # (T, h+1, 2) absolute-time forecasts
    z: float = 0.0
    n_prev: int = 0
    cost: float = 0.0
    t_complete: Optional[float] = None
    alloc_spot: List[int] = field(default_factory=list)
    alloc_od: List[int] = field(default_factory=list)

    def slack(self, t: int, tput: ThroughputConfig) -> np.float32:
        """Slots to spare if finished at N^max from now on (can be < 0).

        float32 on purpose: the fleet engine sorts the same key, so the
        waterfall order cannot drift between the oracle and the engine."""
        remaining = np.float32(max(self.job.workload - self.z, 0.0))
        h_max = (np.float32(tput.alpha) * np.float32(self.job.n_max)
                 + np.float32(tput.beta))
        deadline_abs = self.arrival + self.job.deadline
        return np.float32(deadline_abs - t) - remaining / h_max


@dataclass
class JobResult:
    job_id: int
    utility: float
    value: float
    cost: float
    completion_time: float
    completed_by_deadline: bool


class MultiJobScheduler:
    """Slot-synchronous scheduler over a shared market trace."""

    def __init__(self, tput: ThroughputConfig, trace: Trace):
        self.tput = tput
        self.trace = trace
        self.active: List[ActiveJob] = []
        self.done: List[JobResult] = []
        self._next_id = 0

    def submit(self, t: int, job: JobConfig, policy: BasePolicy,
               pred: Optional[np.ndarray] = None) -> int:
        policy.reset(job, self.tput)
        aj = ActiveJob(self._next_id, job, policy, arrival=t, pred=pred)
        self.active.append(aj)
        self._next_id += 1
        return aj.job_id

    # ------------------------------------------------------------------
    def step(self, t: int):
        """One market slot: demand at full supply, then least-slack grants."""
        price = float(self.trace.prices[t])
        supply = int(self.trace.avail[t])
        live = [aj for aj in self.active
                if 0 <= t - aj.arrival < aj.job.deadline]

        # Phase 1: every live job demands against the FULL slot supply.
        demands = []
        for aj in live:
            pred = None
            if aj.pred is not None:
                pred = np.array(aj.pred[t], copy=True)
                # the pool caps what the present slot can deliver; future
                # rows stay the global forecast
                pred[0, 1] = min(pred[0, 1], supply)
            obs = Obs(t=t - aj.arrival, price=price, avail=supply,
                      z_prev=aj.z, n_prev=aj.n_prev, pred=pred)
            n_o, n_s = aj.policy.decide(obs)
            n_s = int(np.clip(n_s, 0, min(supply, aj.job.n_max)))
            n_o = int(np.clip(n_o, 0, aj.job.n_max - n_s))
            demands.append((aj, n_o, n_s))

        # Phase 2: least-slack-first waterfall over the shared pool; the
        # job-id tie-break keeps the order total (and matches core.fleet).
        demands.sort(key=lambda d: (d[0].slack(t, self.tput), d[0].job_id))
        residual = supply
        a32 = np.float32(self.tput.alpha)
        b32 = np.float32(self.tput.beta)
        for aj, n_o, n_s in demands:
            n_s = min(n_s, residual)
            residual -= n_s
            n = n_o + n_s
            if 0 < n < aj.job.n_min:  # grant fell below N^min: top up with od
                n_o += aj.job.n_min - n
                n = n_o + n_s
            local_t = t - aj.arrival

            mu = 1.0 if n == aj.n_prev else (
                self.tput.mu1 if n > aj.n_prev else self.tput.mu2
            )
            if n == 0 and aj.n_prev == 0:
                mu = 1.0
            # float32 execution arithmetic, op for op the engine's _execute:
            # the progress trajectories stay bit-aligned with core.fleet, so
            # decisions downstream of z (the window DP's argmax sits on
            # near-ties) cannot flip between the oracle and the engine
            wl32 = np.float32(aj.job.workload)
            z32 = np.float32(aj.z)
            work = np.float32(mu) * (
                a32 * np.float32(n) + b32 if n > 0 else np.float32(0.0)
            )
            aj.cost += n_s * price + n_o * aj.job.on_demand_price
            aj.alloc_spot.append(n_s)
            aj.alloc_od.append(n_o)
            if work > 0 and z32 + work >= wl32 and aj.t_complete is None:
                frac = (wl32 - z32) / max(work, np.float32(1e-9))
                aj.t_complete = float(np.float32(local_t) + frac)
            aj.z = float(min(z32 + work, wl32))
            aj.n_prev = n

        # retire finished / past-deadline jobs
        still = []
        for aj in self.active:
            if self._retired(aj, t):
                self.done.append(self._finalize(aj))
            else:
                still.append(aj)
        self.active = still

    @staticmethod
    def _retired(aj: ActiveJob, t: int) -> bool:
        """Completed, or the deadline passes before the next slot."""
        return (aj.t_complete is not None
                or t - aj.arrival + 1 >= aj.job.deadline)

    # ------------------------------------------------------------------
    def _finalize(self, aj: ActiveJob) -> JobResult:
        job, tput = aj.job, self.tput
        if aj.t_complete is None:
            h_max = tput.alpha * job.n_max + tput.beta
            dt = (job.workload - aj.z) / h_max
            aj.t_complete = job.deadline + dt
            aj.cost += job.on_demand_price * job.n_max * dt
        value = float(value_fn(job, aj.t_complete))
        return JobResult(
            job_id=aj.job_id, utility=value - aj.cost, value=value,
            cost=aj.cost, completion_time=float(aj.t_complete),
            completed_by_deadline=aj.t_complete <= job.deadline,
        )

    # ------------------------------------------------------------------
    def run(self, t_end: int):
        for t in range(t_end):
            if not self.active:
                continue
            self.step(t)
        for aj in self.active:  # anything left at horizon end
            self.done.append(self._finalize(aj))
        self.active = []
        return self.done
