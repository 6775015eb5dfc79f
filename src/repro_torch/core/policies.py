"""Online GPU provisioning policies (paper Sec. IV + baselines Sec. VI-A):
the python reference policies, a copy of the JAX package's
``core/policies.py`` whose AHAP solves its window through the port's
``window_opt.solve_window_numpy`` (K1's table entry on the card) on the
policy's own device.

Conventions: slots are 0-indexed; at slot t the policy observes the current
spot price/availability (and forecasts, if predictive) plus the job progress
Z_{t-1} accumulated so far, and outputs (n_o, n_s). Expected progress by the
*end* of slot t is Z^exp = L/d * (t+1) (Eq. 6).

AHAP (Alg. 1): Committed-Horizon-Control with prediction window omega,
commitment level v, and spot price threshold sigma. The inner problem
(Eq. 10) is solved exactly by window_opt.solve_window. The final decision
averages the plans committed over the last v steps (the paper's Line 14-15
writes a bare sum but describes — and CHC defines — an average).

AHANP (Alg. 3): reactive fallback on indicators z_hat (progress ratio),
p_hat = p^s/(sigma p^o), n_hat (availability change ratio).

Baselines: OD-Only, MSU (maximal spot utilization), UP (uniform progress,
Wu et al. NSDI'24 [16]).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.window_opt import solve_window_numpy


@dataclass
class Obs:
    t: int
    price: float
    avail: int
    z_prev: float
    n_prev: int
    pred: Optional[np.ndarray] = None  # (horizon+1, 2): [j] = forecast t+j


class BasePolicy:
    name = "base"

    def reset(self, job: JobConfig, tput: ThroughputConfig):
        self.job, self.tput = job, tput

    def decide(self, obs: Obs) -> Tuple[int, int]:  # (n_o, n_s)
        raise NotImplementedError

    def _feasible(self, n_o: int, n_s: int, obs: Obs) -> Tuple[int, int]:
        job = self.job
        n_s = int(min(n_s, obs.avail, job.n_max))
        n_o = int(max(n_o, 0))
        total = n_o + n_s
        if total <= 0:
            return 0, 0
        if total < job.n_min:
            # top up with the cheaper source
            need = job.n_min - total
            if obs.price <= job.on_demand_price and obs.avail - n_s >= need:
                n_s += need
            else:
                n_o += need
        if n_o + n_s > job.n_max:
            over = n_o + n_s - job.n_max
            drop_od = min(over, n_o) if obs.price <= job.on_demand_price else 0
            n_o -= drop_od
            over -= drop_od
            n_s -= over
        return int(n_o), int(n_s)


# ---------------------------------------------------------------------------
# AHAP — Algorithm 1
# ---------------------------------------------------------------------------

@dataclass
class AHAPParams:
    omega: int = 3       # prediction window
    v: int = 1           # commitment level (1 <= v <= omega)
    sigma: float = 0.7   # spot price threshold (fraction of p^o)
    # BEYOND-PAPER (Robust-AHAP): discount factor applied to *predicted*
    # future availability (the present is observed). Over-trusting noisy
    # availability forecasts under-provisions on-demand and slips deadlines;
    # rho < 1 hedges. rho = 1 recovers the paper's AHAP exactly.
    rho: float = 1.0


class AHAP(BasePolicy):
    """``device`` is where each window solve runs (None: the card)."""

    name = "ahap"

    def __init__(self, params: AHAPParams, device=None):
        assert 1 <= params.v <= max(params.omega, 1)
        self.p = params
        self.device = device

    def reset(self, job, tput):
        super().reset(job, tput)
        self._plans: List[Tuple[int, np.ndarray, np.ndarray]] = []  # (t0, n_o seq, n_s seq)

    def _threshold_plan(self, obs: Obs, pred: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Ahead of schedule: take all spot priced under sigma*p^o (Lines 5-11)."""
        job, p = self.job, self.p
        w1 = p.omega + 1
        n_s = np.zeros(w1, int)
        for j in range(w1):
            price_j = pred[j, 0]
            avail_j = int(pred[j, 1])
            if price_j <= p.sigma * job.on_demand_price and avail_j >= job.n_min:
                n_s[j] = min(avail_j, job.n_max)
        return np.zeros(w1, int), n_s

    def _discounted(self, obs: Obs, w1: int) -> np.ndarray:
        """Forecast window with Robust-AHAP availability pessimism (rho)."""
        pred = np.array(obs.pred[:w1], copy=True)
        if self.p.rho < 1.0:
            pred[1:, 1] = np.floor(self.p.rho * pred[1:, 1])
        return pred

    def decide(self, obs: Obs) -> Tuple[int, int]:
        job, tput, p = self.job, self.tput, self.p
        assert obs.pred is not None, "AHAP needs forecasts"
        w1 = p.omega + 1
        z_exp_end = job.workload / job.deadline * min(obs.t + 1 + p.omega, job.deadline)
        pred = self._discounted(obs, w1)

        if obs.z_prev >= z_exp_end:  # ahead of schedule through the window
            plan_o, plan_s = self._threshold_plan(obs, pred)
        else:  # behind: CHC window problem (Eq. 10)
            slots_to_deadline = max(job.deadline - obs.t, 0)
            plan_o, plan_s, _ = solve_window_numpy(
                job, tput, obs.z_prev, slots_to_deadline,
                pred[:, 0], pred[:, 1], job.on_demand_price,
                device=self.device,
            )
        self._plans.append((obs.t, np.asarray(plan_o), np.asarray(plan_s)))
        if len(self._plans) > p.v:
            self._plans = self._plans[-p.v :]

        # committed decision: average the last v plans' entries for slot t
        os_, ss_, cnt = 0.0, 0.0, 0
        for t0, po_, ps_ in self._plans:
            j = obs.t - t0
            if 0 <= j < len(po_):
                os_ += po_[j]
                ss_ += ps_[j]
                cnt += 1
        # round-half-up, computed identically to the fast-sim twin
        # (int(round()) is half-to-even and diverges on f32/f64 boundaries)
        n_o = int(math.floor(os_ / max(cnt, 1) + 0.5))
        n_s = int(math.floor(ss_ / max(cnt, 1) + 0.5))
        n_s = min(n_s, obs.avail)  # Line 15: actual availability caps spot
        if n_o + n_s == 0:
            return 0, 0
        return self._feasible(n_o, n_s, obs)


# ---------------------------------------------------------------------------
# AHANP — Algorithm 3
# ---------------------------------------------------------------------------

@dataclass
class AHANPParams:
    sigma: float = 0.7


class AHANP(BasePolicy):
    name = "ahanp"

    def __init__(self, params: AHANPParams):
        self.p = params

    def reset(self, job, tput):
        super().reset(job, tput)
        self._prev_avail: Optional[int] = None

    def decide(self, obs: Obs) -> Tuple[int, int]:
        job, p = self.job, self.p
        z_exp = job.workload / job.deadline * obs.t  # expected by end of slot t-1
        z_hat = obs.z_prev / z_exp if z_exp > 0 else 1.0
        p_hat = obs.price / (p.sigma * job.on_demand_price)
        prev_av = self._prev_avail if self._prev_avail is not None else obs.avail
        if obs.avail == 0:
            n_hat = 0.0
        elif prev_av == 0:
            n_hat = math.inf
        else:
            n_hat = obs.avail / prev_av
        self._prev_avail = obs.avail

        n_prev = obs.n_prev
        if z_hat >= 1.0:
            if n_hat == 0.0:
                n = 0                                          # case 1: idle
            elif n_hat <= 0.5:
                n = max(int(0.5 * n_prev), job.n_min)          # case 2: shrink
            elif n_hat <= 1.0:
                n = n_prev                                     # case 3: hold
            elif p_hat > 1.0:
                n = n_prev                                     # case 4: hold (pricey)
            else:
                n = max(n_prev, obs.avail)                     # case 5: grab cheap spot
        else:
            n = max(2 * n_prev, job.n_min)                     # cases 6-7: double
        if n <= 0:
            return 0, 0
        n = int(np.clip(n, job.n_min, job.n_max))
        n_s = min(obs.avail, n)  # spot-first split (Lines 6-7)
        return self._feasible(n - n_s, n_s, obs)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

class ODOnly(BasePolicy):
    """Constant on-demand allocation sized to finish exactly at the deadline."""

    name = "od_only"

    def decide(self, obs: Obs) -> Tuple[int, int]:
        job, tput = self.job, self.tput
        remaining = max(job.workload - obs.z_prev, 0.0)
        slots_left = job.deadline - obs.t
        if remaining <= 0 or slots_left <= 0:
            return 0, 0
        need = math.ceil(remaining / slots_left / tput.alpha)
        return self._feasible(int(np.clip(need, job.n_min, job.n_max)), 0, obs)


class MSU(BasePolicy):
    """Maximal Spot Utilization: all spot early; on-demand only once the
    remaining slots at N^max would no longer finish the job."""

    name = "msu"

    def decide(self, obs: Obs) -> Tuple[int, int]:
        job, tput = self.job, self.tput
        remaining = max(job.workload - obs.z_prev, 0.0)
        if remaining <= 0:
            return 0, 0
        n_s = min(obs.avail, job.n_max)
        slots_left = job.deadline - obs.t
        h_max = tput.alpha * job.n_max + tput.beta
        panic = remaining > h_max * max(slots_left - 1, 0)
        n_o = 0
        if panic:
            need = math.ceil(remaining / max(slots_left, 1) / tput.alpha)
            n_o = max(0, min(need, job.n_max) - n_s)
        if n_s + n_o == 0:
            return 0, 0
        return self._feasible(n_o, n_s, obs)


class MSUWeak(MSU):
    """The paper's literal MSU: switches to on-demand only when the remaining
    slots at N^max can no longer finish even with zero margin — mu-blind, so
    reconfiguration losses make it miss deadlines under droughts (this is the
    variant the paper's -54.8% headline punishes; our default MSU adds a
    one-slot safety margin and is much stronger)."""

    name = "msu_weak"

    def decide(self, obs: Obs) -> Tuple[int, int]:
        job, tput = self.job, self.tput
        remaining = max(job.workload - obs.z_prev, 0.0)
        if remaining <= 0:
            return 0, 0
        n_s = min(obs.avail, job.n_max)
        slots_left = job.deadline - obs.t
        h_max = tput.alpha * job.n_max + tput.beta
        panic = remaining > h_max * max(slots_left, 0)
        n_o = 0
        if panic:
            n_o = max(0, job.n_max - n_s)
        if n_s + n_o == 0:
            return 0, 0
        return self._feasible(n_o, n_s, obs)


def rand_commit_frac(q: float) -> float:
    """Inverse CDF of the optimal randomized commitment distribution at
    quantile q (float64; callers cast to f32 so the python policies and the
    fast-sim lanes floor the same bits). The ski-rental-optimal density
    on the normalized deadline is p(x) = e^x/(e-1), so
    F^{-1}(q) = log(1 + q (e - 1))."""
    return float(np.log1p(q * (np.e - 1.0)))


def uniform_commit_frac(q: float) -> float:
    """Uniform-commitment quantile function: F^{-1}(q) = q. The naive
    alternative to the ski-rental-optimal family — each pool member commits
    at a uniformly spread fraction of the deadline. Useful as a control for
    how much the optimal commitment density buys (ROADMAP 'grow the cheap
    lane')."""
    return float(q)


@dataclass
class RandDeadlineParams:
    q: float = 0.5  # quantile of the optimal commitment CDF, in (0, 1)
    # commitment fraction override: None derives the ski-rental-optimal
    # fraction from q via rand_commit_frac; any other quantile family
    # (e.g. uniform_commit_frac) precomputes its fraction and passes it here.
    commit_frac: Optional[float] = None


class RandDeadline(BasePolicy):
    """BEYOND-PAPER (arXiv:2601.14612): randomized commitment-threshold
    strategy. All-spot (MSU-style, no panic logic) before the committed
    slot tau = floor(F^{-1}(q) * d); from tau on, on-demand sized to finish
    exactly at the deadline (OD-Only sizing). The randomization lives in
    the *pool*: each member carries one quantile of the optimal commitment
    distribution, and the selector learns which quantile fits the market.

    The torch twin is fast_sim._rand_rule — tau is computed with the same f32
    multiply + floor so the two commit on exactly the same slot."""

    name = "rand_deadline"

    def __init__(self, params: RandDeadlineParams):
        assert 0.0 <= params.q <= 1.0, params
        self.p = params
        cf = (rand_commit_frac(params.q) if params.commit_frac is None
              else params.commit_frac)
        self.commit_frac = np.float32(cf)

    def decide(self, obs: Obs) -> Tuple[int, int]:
        job, tput = self.job, self.tput
        remaining = max(job.workload - obs.z_prev, 0.0)
        slots_left = job.deadline - obs.t
        if remaining <= 0 or slots_left <= 0:
            return 0, 0
        tau = float(np.floor(self.commit_frac * np.float32(job.deadline)))
        if obs.t >= tau:  # committed: guarantee the deadline on-demand
            need = math.ceil(remaining / max(slots_left, 1) / tput.alpha)
            n_o, n_s = int(np.clip(need, job.n_min, job.n_max)), 0
        else:  # pre-commitment: ride whatever spot there is
            n_o, n_s = 0, min(obs.avail, job.n_max)
        if n_o + n_s == 0:
            return 0, 0
        return self._feasible(n_o, n_s, obs)


# ---------------------------------------------------------------------------
# Multi-region selection (BEYOND-PAPER, SkyNomad arXiv:2601.06520)
# ---------------------------------------------------------------------------

# Region-selection strategy ids (the ``rsel`` slot of the pool encoding).
RSEL_FIXED, RSEL_PRICE, RSEL_AVAIL, RSEL_PRED = 0, 1, 2, 3
N_RSEL = 4
RSEL_NAMES = {0: "fixed", 1: "greedy_price", 2: "greedy_avail",
              3: "pred_horizon"}

# availability-infeasible regions (avail < N^min) are pushed out of the
# argmin with a large additive penalty rather than masked, so a job stuck
# with *every* region infeasible still has a deterministic (cheapest) pick
RSEL_BIG = np.float32(1e6)

# pred_horizon averages a FIXED-width forecast window so the reference and
# the fast lanes score identically regardless of the predictor's horizon:
# shorter forecasts are edge-padded, longer ones trimmed. Must equal
# fast_sim.W1MAX (asserted there), which pads its prediction inputs the
# same way (prepare_inputs_regions).
RSEL_PRED_WINDOW = 6


@dataclass
class RegionSelectorParams:
    strategy: int = RSEL_PRICE   # one of RSEL_*
    margin: float = 0.0          # hysteresis: switch only if better by this


class RegionSelector:
    """Reference per-slot region chooser — the python twin of the vectorized
    score + hysteresis step inside fast_sim.simulate_pool_regions.

    Scores are LOWER-better, computed in float32 so the f32 fast-sim lanes
    and this reference make identical switch decisions:

      fixed         all-zero (stay wherever the job was placed)
      greedy_price  observed price, +RSEL_BIG where avail < N^min
      greedy_avail  -observed availability
      pred_horizon  mean over the forecast window of predicted price,
                    +RSEL_BIG where predicted avail < N^min

    The first ``step`` places the job at the argmin for free (initial
    placement is not a migration); afterwards a switch to the argmin region
    happens only when its score beats the current region's by more than
    ``margin`` (hysteresis — prevents thrash on noisy scores) and no
    checkpoint transfer is already in flight. A switch starts a migration of
    ``delta_mig`` slots during which the job holds zero instances.
    """

    def __init__(self, params: Optional[RegionSelectorParams] = None):
        self.p = params or RegionSelectorParams()
        assert self.p.strategy in RSEL_NAMES, self.p

    def reset(self, job: JobConfig, delta_mig: int):
        self.job, self.delta_mig = job, int(delta_mig)
        self.cur: Optional[int] = None
        self.mig_left = 0

    def scores(self, prices_t, avail_t, pred_t=None) -> np.ndarray:
        """(R,) float32 scores for one slot. ``pred_t`` is the (R, h+1, 2)
        forecast made this slot (required for pred_horizon)."""
        s, n_min = self.p.strategy, self.job.n_min
        prices_t = np.asarray(prices_t, np.float32)
        avail_t = np.asarray(avail_t)
        if s == RSEL_FIXED:
            return np.zeros(len(prices_t), np.float32)
        if s == RSEL_PRICE:
            dead = (avail_t < n_min).astype(np.float32)
            return (prices_t + RSEL_BIG * dead).astype(np.float32)
        if s == RSEL_AVAIL:
            return -avail_t.astype(np.float32)
        assert pred_t is not None, "pred_horizon needs forecasts"
        pred_t = np.asarray(pred_t, np.float32)[:, :RSEL_PRED_WINDOW]
        if pred_t.shape[1] < RSEL_PRED_WINDOW:  # edge-pad like the fast path
            pad = np.repeat(pred_t[:, -1:],
                            RSEL_PRED_WINDOW - pred_t.shape[1], axis=1)
            pred_t = np.concatenate([pred_t, pad], axis=1)
        dead = (pred_t[..., 1] < np.float32(n_min)).astype(np.float32)
        eff = pred_t[..., 0] + RSEL_BIG * dead          # (R, RSEL_PRED_WINDOW)
        return eff.mean(axis=-1, dtype=np.float32)

    def step(self, sc: np.ndarray):
        """Consume one slot's scores -> (region, migrating, switched)."""
        best = int(np.argmin(sc))
        if self.cur is None:  # initial placement, free
            self.cur = best
            return self.cur, False, False
        switched = (
            best != self.cur
            and self.mig_left == 0
            and bool(np.float32(sc[best]) + np.float32(self.p.margin)
                     < np.float32(sc[self.cur]))
        )
        if switched:
            self.cur = best
            self.mig_left = self.delta_mig
        else:
            self.mig_left = max(self.mig_left - 1, 0)
        return self.cur, self.mig_left > 0, switched


class UP(BasePolicy):
    """Uniform Progress (Wu et al. [16]): track the L/d reference line; spot
    when available, on-demand only when behind and spot is insufficient."""

    name = "up"

    def decide(self, obs: Obs) -> Tuple[int, int]:
        job, tput = self.job, self.tput
        remaining = max(job.workload - obs.z_prev, 0.0)
        if remaining <= 0:
            return 0, 0
        rate = job.workload / job.deadline
        deficit = max(0.0, rate * obs.t - obs.z_prev)
        need = math.ceil((rate + deficit) / tput.alpha)
        need = int(np.clip(need, job.n_min, job.n_max))
        n_s = min(obs.avail, need)
        n_o = need - n_s if deficit > 0 else 0
        if n_s + n_o == 0 and deficit > 0:
            n_o = need
        if n_s + n_o == 0:
            return 0, 0
        return self._feasible(n_o, n_s, obs)
