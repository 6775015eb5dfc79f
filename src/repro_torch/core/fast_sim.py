"""Vectorized policy-pool simulator in torch: every (job, policy) pair of the
pool simulated over the market slots at once.

Port of the JAX package's ``core/fast_sim.py``. Semantics,
rounding and feasibility rules are the reference's op for op; what changes
is the batching. The reference vmaps a per-job scan over the jobs axis; here
the state is one (K jobs, P lanes) batch, the scan is a Python loop over
slots, and job fields ride as (K, 1) columns. The pool is partitioned by
``kind``: the AHAP lanes of every job are flattened into ONE (K * P_ahap)
row batch, so each slot issues exactly one ``solve_window_batch`` call —
one K1 launch on the card. The other kinds (AHANP/OD/MSU/UP/RAND_DEADLINE)
run a cheap loop that never touches the window DP, and the two parts are
scattered back to pool order.

:func:`simulate_pool_regions` layers per-slot region selection over the
same two scans (an R-region market, one current region per lane).
:func:`simulate_pool_jobs_sharded` / :func:`simulate_pool_regions_sharded`
lay the (jobs x lanes) grid over the pool mesh (``launch.mesh``), one rank
a shard. The seed path (:func:`simulate_pool_monolithic`,
:func:`simulate_one`) runs every rule on every lane: the baseline and the
partitioned path's equivalence oracle.

Two flags ride every pool entry point, as in the reference: ``collect``
adds the per-slot ``tel_*`` flight-recorder series (repro_torch.obs), and
``fallback`` (a :class:`repro_torch.chaos.FallbackConfig`) arms the AHAP
lanes' prediction-failure monitor. With their defaults the loops run
exactly the ops they run without them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.job import exact_div, value_fn
from repro_torch.core.policies import RSEL_BIG, RSEL_PRED_WINDOW
from repro_torch.core.policy_pool import (KIND_AHANP, KIND_AHAP, KIND_MSU,
                                          KIND_OD, KIND_RAND, KIND_UP)
from repro_torch.core.window_opt import solve_window_batch
from repro_torch.device import resolve_device, to_device

W1MAX = 6   # max omega + 1
VMAX = 5    # max commitment level
NTABLE = 16  # unit-table width (paper availability cap)

_I32, _F32 = torch.int32, torch.float32


class JobArrays(NamedTuple):
    """Stacked (K,) job fields: numpy leaves on the host, tensors once an
    entry point has moved them to its device (:func:`jobs_to`)."""
    workload: object            # f32
    deadline: object            # i32 (dynamic; the loop runs d_max slots)
    n_min: object               # i32
    n_max: object               # i32
    value: object               # f32
    gamma: object               # f32
    p_o: object                 # f32

    @staticmethod
    def of(job: JobConfig) -> "JobArrays":
        """One JobConfig as scalar numpy leaves of the reference's dtypes."""
        return JobArrays(
            np.float32(job.workload), np.int32(job.deadline),
            np.int32(job.n_min), np.int32(job.n_max),
            np.float32(job.value), np.float32(job.gamma),
            np.float32(job.on_demand_price),
        )


_JOB_DTYPES = (_F32, _I32, _I32, _I32, _F32, _F32, _F32)
_JOB_NP = (np.float32, np.int32, np.int32, np.int32, np.float32, np.float32,
           np.float32)


def jobs_to(jobs: JobArrays, device) -> JobArrays:
    """JobArrays with every leaf a tensor of the reference's dtype on
    ``device``."""
    return JobArrays(*[to_device(f, dt, device)
                       for f, dt in zip(jobs, _JOB_DTYPES)])


def stack_jobs(jobs) -> JobArrays:
    """A list of JobConfig -> stacked (K,) JobArrays with numpy leaves."""
    cols = zip(*[(j.workload, j.deadline, j.n_min, j.n_max, j.value, j.gamma,
                  j.on_demand_price) for j in jobs])
    return JobArrays(*[np.asarray(c, dt) for c, dt in zip(cols, _JOB_NP)])


def slice_jobs(jobs: JobArrays, start: int, stop: int) -> JobArrays:
    """Job-axis slice — the unit of the engine's job-chunked mode."""
    return JobArrays(*[f[start:stop] for f in jobs])


def concat_jobs(parts) -> JobArrays:
    """Concatenate stacked JobArrays along the job axis (host numpy leaves)
    — the inverse of repeated :func:`slice_jobs`; how the scenario grid
    stacks per-regime job blocks regime-major onto one jobs axis."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    return JobArrays(*[
        np.concatenate([np.asarray(getattr(p, f)) for p in parts])
        for f in JobArrays._fields
    ])


def unstack_jobs(jobs: JobArrays):
    """Stacked (K,) JobArrays -> list of JobConfig (host scalars) — the
    inverse of :func:`stack_jobs`, for per-job host paths."""
    n = int(np.shape(jobs.workload)[0])
    rows = [_host(f) for f in jobs]
    return [
        JobConfig(
            workload=float(rows[0][k]), deadline=int(rows[1][k]),
            n_min=int(rows[2][k]), n_max=int(rows[3][k]),
            value=float(rows[4][k]), gamma=float(rows[5][k]),
            on_demand_price=float(rows[6][k]),
        )
        for k in range(n)
    ]


def _job_cfg(j: JobArrays) -> JobConfig:
    return JobConfig(
        workload=j.workload, deadline=j.deadline, n_min=j.n_min,
        n_max=j.n_max, value=j.value, gamma=j.gamma, on_demand_price=j.p_o,
    )


def _columns(jobs: JobArrays, nd: int = 1) -> JobArrays:
    """(K,) leaves as (K, 1, ..) columns that broadcast over the lane axes."""
    return JobArrays(*[f.reshape(f.shape + (1,) * nd) for f in jobs])


def _clip(x, lo, hi):
    """``jnp.clip`` on integer tensors: minimum(maximum(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _feasible(n_o, n_s, price, avail, j: JobArrays):
    """Mirror of BasePolicy._feasible."""
    n_s = torch.minimum(torch.minimum(n_s, avail), j.n_max)
    n_o = torch.clamp_min(n_o, 0)
    total = n_o + n_s
    need = torch.clamp_min(j.n_min - total, 0)
    spot_room = (price <= j.p_o) & (avail - n_s >= need)
    under = (total > 0) & (total < j.n_min)
    n_s = torch.where(under & spot_room, n_s + need, n_s)
    n_o = torch.where(under & ~spot_room, n_o + need, n_o)
    over = torch.clamp_min(n_o + n_s - j.n_max, 0)
    drop_od = torch.where(price <= j.p_o, torch.minimum(over, n_o), 0)
    n_o = n_o - drop_od
    n_s = n_s - (over - drop_od)
    zero = total <= 0
    return torch.where(zero, 0, n_o), torch.where(zero, 0, n_s)


def _sim_clip(n_o, n_s, avail, j: JobArrays):
    """Mirror of simulate()'s hard feasibility clip."""
    n_s = torch.minimum(torch.clamp_min(n_s, 0), torch.minimum(avail, j.n_max))
    n_o = torch.minimum(torch.clamp_min(n_o, 0), j.n_max - n_s)
    n = n_o + n_s
    n_o = torch.where((n > 0) & (n < j.n_min), n_o + (j.n_min - n), n_o)
    return n_o, n_s


# ---------------------------------------------------------------------------
# Decision rules. State tensors are (K, P); ``j`` holds (K, 1) job columns,
# ``price``/``av`` are this slot's (K, 1) market and ``t`` the slot index.
# ``t`` may also be an i32 tensor of per-row local clocks that broadcasts
# against the state (the fleet engine's ``t - arrival``, as the reference
# allows a scalar or a vector): an int takes the ops it always took, and a
# tensor the same ops on its f32 values, so both give the same bits.
# ---------------------------------------------------------------------------

def _tf(t):
    """The slot clock as the f32 operand of the rules' float arithmetic:
    ``float(t)`` for an int (exact, and rounded to f32 by the op), the
    tensor cast to f32 otherwise."""
    return float(t) if isinstance(t, int) else t.to(_F32)


def _ahap_precompute(j3: JobArrays, omega, sigma, rho, t, pred_t):
    """AHAP scaffolding for slot ``t``: omega/sigma/rho are (P,) lane
    parameters, ``j3`` holds (K, 1, 1) job columns (or (1, P, 1), one job
    per lane, as the fleet passes them) and pred_t is the slot's (K,
    W1MAX, 2) forecast; a tensor ``t`` is (P,) or (1, P). Returns (pr (2,
    K, P, W1MAX): prices, then availability, each dense, as K1 reads them;
    thr_s (K, P, W1MAX) i32, z_exp_end (K, P), eff_slots (K, P) i32).

    Robust-AHAP discounts *predicted* availability (entries j >= 1 only)."""
    k, p = pred_t.shape[0], omega.shape[0]
    disc_av = torch.floor(rho[None, :, None] * pred_t[:, None, :, 1])
    disc_av[..., 0] = pred_t[:, None, 0, 1]      # the present is observed
    pr = torch.stack([pred_t[:, None, :, 0].expand(k, p, W1MAX), disc_av])
    in_w = (torch.arange(W1MAX, device=omega.device)[None, None, :]
            <= omega[None, :, None])
    j2 = JobArrays(*[f[:, :, 0] for f in j3])
    z_exp_end = j2.workload / j2.deadline * torch.minimum(
        (t + 1 + omega[None, :]).to(_F32), j2.deadline.to(_F32)
    )
    thr_s = torch.where(
        in_w
        & (pr[0] <= sigma[None, :, None] * j3.p_o)
        & (pr[1] >= j3.n_min),
        torch.minimum(pr[1].to(_I32), j3.n_max),
        0,
    )
    eff_slots = torch.minimum(j2.deadline - t, omega[None, :] + 1)
    return pr, thr_s, z_exp_end, eff_slots


def _ahap_rule_batch(rows: JobConfig, j: JobArrays, tput, v, backend, device,
                     z, t, price, av, plans, pr_t, thr_t, zee_t, eff_t):
    """AHAP (Alg. 1) for every (job, AHAP lane): CHC window solve when
    behind, threshold plan when ahead, v-step plan averaging. The window
    solve is ONE ``solve_window_batch`` call over the flattened
    (K * P) rows (``rows`` holds the per-row job fields). A tensor ``t``
    holds one local clock per lane (K = 1, the fleet's jobs as lanes).
    Returns (n_o, n_s, new_plans)."""
    k, p = z.shape
    b = k * p
    ahead = z >= zee_t
    chc_o, chc_s, _ = solve_window_batch(
        rows, tput, z.reshape(b), eff_t.reshape(b),
        pr_t[0].reshape(b, W1MAX),
        pr_t[1].to(_I32).reshape(b, W1MAX),
        rows.on_demand_price, table_n=NTABLE, backend=backend, device=device,
    )
    plan = torch.where(
        ahead[..., None, None],
        torch.stack([torch.zeros_like(thr_t), thr_t], dim=-1),
        torch.stack([chc_o, chc_s], dim=-1).reshape(k, p, W1MAX, 2),
    ).to(_F32)                                          # (K, P, W1MAX, 2)
    plans = torch.cat([plan[:, :, None], plans[:, :, :-1]], dim=2)
    kk = torch.arange(VMAX, device=z.device)
    # a plan only exists if it was actually made (k <= t)
    made = kk[None, :] <= (t if isinstance(t, int) else t.reshape(-1, 1))
    valid = (kk[None, :] < v[:, None]) & made
    valid = valid[None, :, :, None].to(_F32)           # (1, P, VMAX, 1)
    # plans[..., i, min(i, W1MAX - 1), :]: the i-th newest plan's decision
    # for the current slot (the reference's advanced-index gather)
    diag = plans[:, :, kk, torch.clamp_max(kk, W1MAX - 1)]  # (K, P, VMAX, 2)
    cnt = torch.clamp_min(valid.sum(dim=(2, 3)), 1.0)  # (1, P)
    avg = (diag * valid).sum(dim=2) / cnt[..., None]   # (K, P, 2)
    # round-half-up, matching the python reference exactly
    ah_o = torch.floor(avg[..., 0] + 0.5).to(_I32)
    ah_s = torch.minimum(torch.floor(avg[..., 1] + 0.5).to(_I32), av)
    ah_zero = (ah_o + ah_s) == 0
    ah_o_f, ah_s_f = _feasible(ah_o, ah_s, price, av, j)
    ah_o = torch.where(ah_zero, 0, ah_o_f)
    ah_s = torch.where(ah_zero, 0, ah_s_f)
    return ah_o, ah_s, plans


def _ahanp_rule(j: JobArrays, sigma, z, t, price, av, n_prev,
                prev_avail):
    """AHANP (Alg. 3): reactive indicators z_hat / p_hat / n_hat."""
    z_exp_prev = j.workload / j.deadline * _tf(t)
    z_hat = torch.where(z_exp_prev > 0, z / z_exp_prev, 1.0)
    p_hat = price / (sigma * j.p_o)
    n_hat = torch.where(
        av == 0, 0.0,
        torch.where(prev_avail == 0, torch.inf,
                    av / torch.clamp_min(prev_avail, 1).to(_F32)),
    )
    ahead1 = z_hat >= 1.0
    n_an = torch.where(
        ahead1,
        torch.where(
            av == 0,
            0,
            torch.where(
                n_hat <= 0.5,
                torch.maximum(n_prev // 2, j.n_min),
                torch.where(
                    n_hat <= 1.0,
                    n_prev,
                    torch.where(p_hat > 1.0, n_prev,
                                torch.maximum(n_prev, av)),
                ),
            ),
        ),
        torch.maximum(2 * n_prev, j.n_min),
    )
    an_zero = n_an <= 0
    n_an_c = _clip(n_an, j.n_min, j.n_max)
    an_s = torch.minimum(av, n_an_c)
    an_o_f, an_s_f = _feasible(n_an_c - an_s, an_s, price, av, j)
    return torch.where(an_zero, 0, an_o_f), torch.where(an_zero, 0, an_s_f)


def _od_need(j: JobArrays, tput, z, t):
    """(remaining, slots_left, on-demand units to finish at the deadline)."""
    remaining = torch.clamp_min(j.workload - z, 0.0)
    slots_left = (j.deadline - t).to(_F32)
    od_need = torch.ceil(exact_div(
        remaining / torch.clamp_min(slots_left, 1.0), tput.alpha
    )).to(_I32)
    return remaining, slots_left, od_need


def _od_rule(j: JobArrays, tput, z, t, price, av):
    """OD-Only: constant on-demand sized to finish exactly at the deadline."""
    remaining, slots_left, od_need = _od_need(j, tput, z, t)
    od_zero = (remaining <= 0) | (slots_left <= 0)
    n_o = _clip(od_need, j.n_min, j.n_max)
    od_o_f, od_s_f = _feasible(n_o, torch.zeros_like(n_o), price, av, j)
    return torch.where(od_zero, 0, od_o_f), torch.where(od_zero, 0, od_s_f)


def _msu_rule(j: JobArrays, tput, z, t, price, av):
    """MSU: all spot; on-demand only once N^max can no longer finish."""
    remaining, slots_left, od_need = _od_need(j, tput, z, t)
    ms_s = torch.minimum(av, j.n_max).expand_as(od_need)
    h_max = tput.alpha * j.n_max.to(_F32) + tput.beta
    panic = remaining > h_max * torch.clamp_min(slots_left - 1.0, 0.0)
    ms_o = torch.where(
        panic, torch.clamp_min(torch.minimum(od_need, j.n_max) - ms_s, 0), 0
    )
    ms_zero = (remaining <= 0) | ((ms_s + ms_o) == 0)
    ms_o_f, ms_s_f = _feasible(ms_o, ms_s, price, av, j)
    return torch.where(ms_zero, 0, ms_o_f), torch.where(ms_zero, 0, ms_s_f)


def _up_rule(j: JobArrays, tput, z, t, price, av):
    """UP (Wu et al. [16]): track the L/d line, spot-first."""
    remaining = torch.clamp_min(j.workload - z, 0.0)
    rate = j.workload / j.deadline.to(_F32)
    deficit = torch.clamp_min(rate * _tf(t) - z, 0.0)
    up_need = _clip(torch.ceil(exact_div(rate + deficit,
                                         tput.alpha)).to(_I32),
                    j.n_min, j.n_max)
    up_s = torch.minimum(av, up_need)
    up_o = torch.where(deficit > 0, up_need - up_s, 0)
    up_zero = (remaining <= 0) | ((up_s + up_o) == 0)
    up_o_f, up_s_f = _feasible(up_o, up_s, price, av, j)
    return torch.where(up_zero, 0, up_o_f), torch.where(up_zero, 0, up_s_f)


def _rand_rule(j: JobArrays, tput, cfrac, z, t, price, av):
    """RAND_DEADLINE (arXiv:2601.14612): all-spot before the committed slot
    tau = floor(cfrac * d); from tau on, on-demand sized to finish exactly
    at the deadline."""
    tau = torch.floor(cfrac * j.deadline.to(_F32))
    committed = _tf(t) >= tau
    remaining, slots_left, od_need = _od_need(j, tput, z, t)
    rd_o = torch.where(committed, _clip(od_need, j.n_min, j.n_max), 0)
    rd_s = torch.where(committed, 0, torch.minimum(av, j.n_max))
    rd_zero = (remaining <= 0) | (slots_left <= 0) | ((rd_o + rd_s) == 0)
    rd_o_f, rd_s_f = _feasible(rd_o, rd_s, price, av, j)
    return torch.where(rd_zero, 0, rd_o_f), torch.where(rd_zero, 0, rd_s_f)


def _cheap_rules(kind, sigma, cfrac, j: JobArrays, tput, z, t, price,
                 av, n_prev, prev_avail):
    """Every DP-free rule on the (K, P) state, each lane taking its
    ``kind``'s decision (kind/sigma/cfrac are (1, P)). Returns (n_o,
    n_s)."""
    rules = (
        (KIND_AHANP,
         _ahanp_rule(j, sigma, z, t, price, av, n_prev, prev_avail)),
        (KIND_OD, _od_rule(j, tput, z, t, price, av)),
        (KIND_MSU, _msu_rule(j, tput, z, t, price, av)),
        (KIND_UP, _up_rule(j, tput, z, t, price, av)),
        (KIND_RAND, _rand_rule(j, tput, cfrac, z, t, price, av)),
    )
    n_o = torch.zeros(z.shape, dtype=_I32, device=z.device)
    n_s = torch.zeros(z.shape, dtype=_I32, device=z.device)
    for kind_id, (r_o, r_s) in rules:
        n_o = torch.where(kind == kind_id, r_o, n_o)
        n_s = torch.where(kind == kind_id, r_s, n_s)
    return n_o, n_s


def _execute(j: JobArrays, tput, z, n_prev, cost, done, T, t, n_o, n_s,
             price, av):
    """Mirror of simulate()'s slot execution: hard clip, mu, billing,
    fractional completion. Returns the updated state + (n_o, n_s, active)."""
    active = (t < j.deadline) & ~done
    n_o, n_s = _sim_clip(n_o, n_s, av, j)
    n_o = torch.where(active, n_o, 0)
    n_s = torch.where(active, n_s, 0)
    n = n_o + n_s

    mu = torch.where(n > n_prev, tput.mu1,
                     torch.where(n < n_prev, tput.mu2, 1.0))
    mu = torch.where((n == 0) & (n_prev == 0), 1.0, mu)
    work = mu * torch.where(n > 0, tput.alpha * n.to(_F32) + tput.beta, 0.0)
    will_done = active & (work > 0) & (z + work >= j.workload)
    frac = torch.where(
        work > 0, (j.workload - z) / torch.clamp_min(work, 1e-9), 0.0
    )
    T = torch.where(will_done, _tf(t) + frac, T)
    cost = cost + torch.where(
        active, n_s.to(_F32) * price + n_o.to(_F32) * j.p_o, 0.0
    )
    z = torch.minimum(z + torch.where(active, work, 0.0), j.workload)
    n_prev = torch.where(active, n, n_prev)
    done = done | will_done
    return z, n_prev, cost, done, T, n_o, n_s, active


# flight-recorder slot series (repro_torch.obs), the reference's keys in its
# order: emitted as (K, P, T) result keys when a pool entry point runs with
# collect=True. Order matches _slot_telemetry's return tuple.
_TEL_SLOTS = ("tel_spot_cost", "tel_od_cost", "tel_progress", "tel_active",
              "tel_up", "tel_down", "tel_preempt")

# prediction-health series, emitted ONLY when a collect run also arms the
# fallback monitor: (fallback-active bool, error EWMA f32)
_TEL_FALLBACK = ("tel_fallback", "tel_pred_err")

# floor for the relative-error denominators of the fallback monitor
# (traces clip prices >= 0.02; availability errors normalize by >= 1 unit)
_FB_PRICE_EPS = 0.01


def _f32(x: float) -> float:
    """``x`` rounded to f32, as the reference's ``jnp.float32(x)``."""
    return float(np.float32(x))


def _one_minus(x: float) -> float:
    """``1 - x`` taken in f32, as the reference's ``jnp.float32(1.0) - x``."""
    return float(np.float32(1.0) - np.float32(x))


def _fma(a: float, b, c):
    """``a * b + c`` rounded to f32 once, as XLA's compiled program contracts
    both blends of the monitor (fma(a, b, c) with the product exact in f64;
    the f64 sum rounds only where the exact sum needs over 53 bits)."""
    return (a * b.double() + c.double()).float()


def _fallback_error(fallback, err, price, av, prev1_t):
    """One EWMA update of the prediction-health monitor: blend the relative
    errors of last slot's 1-step-ahead forecast ``prev1_t`` ((K, 2): price,
    avail) against this slot's observed (K, 1) market. ``err`` is (K, 1):
    one value per job, read by every lane of the job (the regional scan
    passes its (K * P) lanes as rows). Each blend is one fused
    multiply-add, as in the reference's compiled program: the monitor's
    threshold test is strict, so an ulp flips a plan."""
    avf = av.to(_F32)
    e_p = (torch.abs(price - prev1_t[:, :1])
           / torch.clamp_min(price, _FB_PRICE_EPS))
    e_a = torch.abs(avf - prev1_t[:, 1:]) / torch.clamp_min(avf, 1.0)
    w_p = _f32(fallback.price_weight)
    lam = _f32(fallback.lam)
    e = _fma(w_p, e_p, _one_minus(w_p) * e_a)
    return _fma(_one_minus(lam), err, lam * e)


def _fallback_prev1(pred):
    """(K, T, 2) realized 1-step-ahead forecast series: at slot t, the value
    the predictor issued at t-1 for t. Slot 0 uses its own observed-present
    row, so the monitor starts cold (zero error)."""
    return torch.cat([pred[:, :1, 0, :], pred[:, :-1, 1, :]], dim=1)


def _slot_telemetry(j: JobArrays, n_prev_before, z, n_o, n_s, active,
                    price, av):
    """One flight-recorder sample, taken AFTER :func:`_execute` ran the
    slot: the spot/on-demand cost split billed this slot, cumulative
    progress, and the reconfiguration events — ``preempt`` flags a shrink
    forced by supply (available spot fell below last slot's allocation).
    Elementwise on the (K, P) state; never called when collect is off."""
    n = n_o + n_s
    act_f = active.to(_F32)
    up = active & (n > n_prev_before)
    down = active & (n < n_prev_before)
    preempt = down & (av < n_prev_before)
    return (
        act_f * n_s.to(_F32) * price,
        act_f * n_o.to(_F32) * j.p_o,
        z,
        active,
        up,
        down,
        preempt,
    )


def _telemetry_out(keys, samples) -> dict:
    """Per-slot samples (a list over slots of tuples in ``keys`` order) as
    (K, P, T) result entries ((J, T) for the fleet's (J,) state), stacked
    once after the loop."""
    return {key: torch.stack(series, dim=-1)
            for key, series in zip(keys, zip(*samples))}


def _finalize(j: JobArrays, tput, z, cost, done, T, no_hist, ns_hist):
    """Termination configuration (N^max on-demand past the deadline)."""
    h_max = tput.alpha * j.n_max.to(_F32) + tput.beta
    dt = torch.clamp_min(j.workload - z, 0.0) / h_max
    T_final = torch.where(done, T, j.deadline.to(_F32) + dt)
    cost_final = cost + torch.where(
        done, 0.0, j.p_o * j.n_max.to(_F32) * dt
    )
    value = value_fn(_job_cfg(j), T_final)
    return {
        "utility": value - cost_final,
        "value": value,
        "cost": cost_final,
        "completion_time": T_final,
        "z_ddl": z,
        "completed": done,
        "n_od": torch.stack(no_hist, dim=-1),
        "n_spot": torch.stack(ns_hist, dim=-1),
    }


def _init_state(k: int, p: int, device):
    """(z, n_prev, cost, done, T) for a fresh (K, P) batch."""
    return (torch.zeros((k, p), dtype=_F32, device=device),
            torch.zeros((k, p), dtype=_I32, device=device),
            torch.zeros((k, p), dtype=_F32, device=device),
            torch.zeros((k, p), dtype=torch.bool, device=device),
            torch.zeros((k, p), dtype=_F32, device=device))


def _simulate_lanes_ahap(omega, v, sigma, rho, jobs: JobArrays, tput,
                         prices, avail, pred, backend, device,
                         collect: bool = False, fallback=None):
    """Every (job, AHAP lane) pair over the market slots. Each slot issues
    ONE window solve over the flattened (K * P) rows.

    ``collect`` adds the ``_TEL_SLOTS`` series. ``fallback`` arms the
    prediction-health monitor: a forecast-error EWMA of shape (K, 1), one
    value per job (every lane of a job reads the same forecast stack),
    updated before the slot's rule; while it exceeds the threshold every
    AHAP lane of the job takes the prediction-free AHANP decision, whose
    "previous availability" is the shifted supply (not the active-masked
    one the cheap lanes carry). The window solve still runs for every row
    every slot, so plans keep updating underneath and recovery resumes
    AHAP with a warm history. With collect also on, the ``_TEL_FALLBACK``
    series join the result."""
    k, dmax = prices.shape
    p = omega.shape[0]
    j, j3 = _columns(jobs), _columns(jobs, 2)
    rows = _job_cfg(JobArrays(*[f[:, None].expand(k, p).reshape(k * p)
                                for f in jobs]))
    z, n_prev, cost, done, T = _init_state(k, p, device)
    plans = torch.zeros((k, p, VMAX, W1MAX, 2), dtype=_F32, device=device)
    if fallback is not None:
        thr = _f32(fallback.threshold)
        prev1 = _fallback_prev1(pred)                   # (K, dmax, 2)
        prev_av = torch.cat([avail[:, :1], avail[:, :-1]], dim=1)
        err = torch.zeros((k, 1), dtype=_F32, device=device)
        lane_sigma = sigma[None, :]
    no_hist, ns_hist, tel = [], [], []
    for t in range(dmax):
        price, av = prices[:, t:t + 1], avail[:, t:t + 1]
        if fallback is not None:
            err = _fallback_error(fallback, err, price, av, prev1[:, t])
            fb = err > thr                              # (K, 1)
        pr_t, thr_t, zee_t, eff_t = _ahap_precompute(
            j3, omega, sigma, rho, t, pred[:, t]
        )
        n_o, n_s, plans = _ahap_rule_batch(
            rows, j, tput, v, backend, device, z, t, price, av, plans,
            pr_t, thr_t, zee_t, eff_t,
        )
        if fallback is not None:
            an_o, an_s = _ahanp_rule(j, lane_sigma, z, t, price, av, n_prev,
                                     prev_av[:, t:t + 1])
            n_o = torch.where(fb, an_o, n_o)
            n_s = torch.where(fb, an_s, n_s)
        n_prev0 = n_prev
        z, n_prev, cost, done, T, n_o, n_s, active = _execute(
            j, tput, z, n_prev, cost, done, T, t, n_o, n_s, price, av
        )
        no_hist.append(n_o)
        ns_hist.append(n_s)
        if collect:
            sample = _slot_telemetry(j, n_prev0, z, n_o, n_s, active, price,
                                     av)
            if fallback is not None:
                sample += (fb.expand(k, p), err.expand(k, p))
            tel.append(sample)
    out = _finalize(j, tput, z, cost, done, T, no_hist, ns_hist)
    if collect:
        keys = _TEL_SLOTS + (_TEL_FALLBACK if fallback is not None else ())
        out.update(_telemetry_out(keys, tel))
    return out


def _simulate_one_cheap(kind, sigma, cfrac, jobs: JobArrays, tput, prices,
                        avail, collect: bool = False, fallback=None):
    """Every (job, non-AHAP lane) pair (AHANP/OD/MSU/UP/RAND_DEADLINE): no
    forecasts, no window DP. kind/sigma/cfrac are (P,) lane parameters.
    ``collect`` adds the ``_TEL_SLOTS`` series. Cheap lanes consume no
    forecasts, so ``fallback`` never changes their decisions; with collect
    it only adds all-zero ``_TEL_FALLBACK`` placeholders, so the merged
    pool result keeps one key set."""
    k, dmax = prices.shape
    p = kind.shape[0]
    j = _columns(jobs)
    kind, sigma, cfrac = kind[None, :], sigma[None, :], cfrac[None, :]
    z, n_prev, cost, done, T = _init_state(k, p, prices.device)
    prev_avail = avail[:, :1].expand(k, p)
    no_hist, ns_hist, tel = [], [], []
    for t in range(dmax):
        price, av = prices[:, t:t + 1], avail[:, t:t + 1]
        n_o, n_s = _cheap_rules(kind, sigma, cfrac, j, tput, z, t, price, av,
                                n_prev, prev_avail)
        n_prev0 = n_prev
        z, n_prev, cost, done, T, n_o, n_s, active = _execute(
            j, tput, z, n_prev, cost, done, T, t, n_o, n_s, price, av
        )
        prev_avail = torch.where(active, av, prev_avail)
        no_hist.append(n_o)
        ns_hist.append(n_s)
        if collect:
            tel.append(_slot_telemetry(j, n_prev0, z, n_o, n_s, active,
                                       price, av))
    out = _finalize(j, tput, z, cost, done, T, no_hist, ns_hist)
    if collect:
        out.update(_telemetry_out(_TEL_SLOTS, tel))
        if fallback is not None:
            out["tel_fallback"] = torch.zeros((k, p, dmax), dtype=torch.bool,
                                              device=prices.device)
            out["tel_pred_err"] = torch.zeros((k, p, dmax), dtype=_F32,
                                              device=prices.device)
    return out


# ---------------------------------------------------------------------------
# Pool entry points: partition by kind, scatter back to pool order
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _partition_lane_args(pool_arrays: dict, with_regions: bool = False):
    """(ahap_idx, other_idx, ahap_args, cheap_args) as numpy: the pool
    encoding is data, so the kind split happens on the host. With
    ``with_regions`` each args tuple also carries the partition's (rsel,
    rmargin) region-strategy slices (stay-put lanes when the encoding has
    no region slots)."""
    arr = {k: _host(v) for k, v in pool_arrays.items()}
    kind = arr["kind"]
    n = len(kind)
    rho = arr.get("rho", np.ones(n, np.float32)).astype(np.float32)
    cfrac = arr.get("cfrac", np.zeros(n, np.float32)).astype(np.float32)
    ahap_idx = np.flatnonzero(kind == KIND_AHAP)
    other_idx = np.flatnonzero(kind != KIND_AHAP)
    extras = lambda idx: ()
    if with_regions:
        rsel = arr.get("rsel", np.zeros(n, np.int32)).astype(np.int32)
        rmargin = arr.get("rmargin", np.zeros(n, np.float32)).astype(
            np.float32)
        extras = lambda idx: (rsel[idx], rmargin[idx])
    ahap_args = (arr["omega"][ahap_idx], arr["v"][ahap_idx],
                 arr["sigma"][ahap_idx], rho[ahap_idx], *extras(ahap_idx))
    cheap_args = (kind[other_idx], arr["sigma"][other_idx], cfrac[other_idx],
                  *extras(other_idx))
    return ahap_idx, other_idx, ahap_args, cheap_args


def _scatter_merge(parts, index_arrays, device):
    """Stitch per-partition result dicts back into pool order (lane axis 1)."""
    if len(parts) == 1:
        return parts[0]
    order = torch.as_tensor(
        np.argsort(np.concatenate(index_arrays), kind="stable"), device=device
    )
    return {
        k: torch.cat([p[k] for p in parts], dim=1)[:, order] for k in parts[0]
    }


# lane parameters of each kind partition, in _partition_lane_args' order:
# (omega, v, sigma, rho[, rsel, rmargin]) and (kind, sigma, cfrac[, rsel,
# rmargin])
_AHAP_LANE_DTYPES = (_I32, _I32, _F32, _F32, _I32, _F32)
_CHEAP_LANE_DTYPES = (_I32, _F32, _F32, _I32, _F32)


def _market_to(jobs: JobArrays, prices, avail, pred, p_od, dev):
    """The entry points' device boundary: jobs and market on ``dev``, avail
    cast to int32, ``p_od`` (scalar or (R,) multipliers, or None) as an
    (R,) f32 tensor."""
    prices = to_device(prices, _F32, dev)
    if p_od is not None:
        p_od = to_device(np.asarray(_host(p_od), np.float32).reshape(-1),
                         _F32, dev).expand(prices.shape[1])
    return (jobs_to(jobs, dev), prices, to_device(avail, _I32, dev),
            to_device(pred, _F32, dev), p_od)


def _run_part(ahap: bool, lane_args, jobs: JobArrays, tput, prices, avail,
              pred, backend, dev, delta_mig, collect, fallback, p_od):
    """One kind partition's lanes (host lane parameters) over ``jobs`` and
    their market (tensors on ``dev``): the AHAP scan or the cheap scan,
    regional when ``delta_mig`` is not None."""
    dts = _AHAP_LANE_DTYPES if ahap else _CHEAP_LANE_DTYPES
    lanes = [to_device(a, dt, dev) for a, dt in zip(lane_args, dts)]
    kw = dict(collect=collect, fallback=fallback)
    if delta_mig is None:
        if ahap:
            return _simulate_lanes_ahap(*lanes, jobs, tput, prices, avail,
                                        pred, backend, dev, **kw)
        return _simulate_one_cheap(*lanes, jobs, tput, prices, avail, **kw)
    if ahap:
        return _simulate_lanes_ahap_regions(
            *lanes, jobs, tput, prices, avail, pred, backend, dev,
            delta_mig, p_od=p_od, **kw)
    return _simulate_one_cheap_regions(*lanes, jobs, tput, prices, avail,
                                       pred, delta_mig, p_od=p_od, **kw)


def _run_partitioned(pool_arrays: dict, jobs: JobArrays, tput, prices,
                     avail, pred, backend, dev, delta_mig=None,
                     collect: bool = False, fallback=None, p_od=None):
    """Partition by kind on the host, run each partition on ``dev``,
    scatter back to pool order: the driver of every unsharded pool entry
    point (inputs already on ``dev``)."""
    ahap_idx, other_idx, ahap_args, cheap_args = _partition_lane_args(
        pool_arrays, with_regions=delta_mig is not None)
    parts, idxs = [], []
    for ahap, idx, args in ((True, ahap_idx, ahap_args),
                            (False, other_idx, cheap_args)):
        if idx.size:
            parts.append(_run_part(ahap, args, jobs, tput, prices, avail,
                                   pred, backend, dev, delta_mig, collect,
                                   fallback, p_od))
            idxs.append(idx)
    return _scatter_merge(parts, idxs, dev)


def simulate_pool_jobs(pool_arrays: dict, jobs: JobArrays,
                       tput: ThroughputConfig, prices, avail, pred,
                       backend: Optional[str] = None, device=None,
                       collect: bool = False, fallback=None) -> dict:
    """Simulate every (job, policy) pair: a dict of (K, P, ...) tensors in
    pool order (utility, value, cost, completion_time, z_ddl, completed,
    n_od, n_spot). ``collect=True`` adds the (K, P, T) ``tel_*``
    flight-recorder series; ``fallback`` (a
    :class:`repro_torch.chaos.FallbackConfig`) arms the AHAP lanes'
    prediction-failure monitor. Both defaults run the ops of the program
    without them.

    ``pool_arrays`` from specs_to_arrays (numpy or tensors); ``jobs``
    stacked (K,) JobArrays; prices/avail (K, d_max), pred
    (K, d_max, W1MAX, 2). Inputs move to ``device`` (None: the card);
    avail is cast to int32 at this boundary. ``backend`` picks the window
    DP (None: "cuda" on the card, "torch" on the CPU)."""
    dev = resolve_device(device)
    jobs, prices, avail, pred, _ = _market_to(jobs, prices, avail, pred,
                                              None, dev)
    return _run_partitioned(pool_arrays, jobs, tput, prices, avail, pred,
                            backend, dev, collect=collect, fallback=fallback)


def simulate_pool(pool_arrays: dict, j: JobArrays, tput: ThroughputConfig,
                  prices, avail, pred, backend: Optional[str] = None,
                  device=None, collect: bool = False, fallback=None) -> dict:
    """One job: ``j`` holds scalar leaves (:meth:`JobArrays.of`),
    prices/avail are (d_max,) and pred (d_max, W1MAX, 2). Returns a dict of
    (P, ...) tensors in pool order; ``collect`` and ``fallback`` as in
    :func:`simulate_pool_jobs`."""
    jobs, prices, avail, pred = _one_job(j, prices, avail, pred)
    out = simulate_pool_jobs(pool_arrays, jobs, tput, prices, avail, pred,
                             backend=backend, device=device,
                             collect=collect, fallback=fallback)
    return {k: v[0] for k, v in out.items()}


# ---------------------------------------------------------------------------
# Sharded entry points: the (jobs x lanes) grid over the pool mesh
# ---------------------------------------------------------------------------
#
# SPMD over torch.distributed, one rank a shard: every rank is called with
# the same full host inputs (as JAX's global arrays), partitions by kind on
# the host, runs its own (jobs block, lanes block) cell of each partition
# through the unsharded scans on its device (K1 once a slot on the cell's
# AHAP rows), then all-gathers the cells so every rank returns the whole
# result. Cells are independent and every op is elementwise over both grid
# axes, so the result equals the unsharded one bit for bit.

def _pad_leading(x, pad: int):
    """Pad axis 0 by repeating the last entry ``pad`` times (a host array or
    a tensor, returned as the same kind; dropped from the result after the
    sharded run)."""
    if not pad:
        return x
    if torch.is_tensor(x):
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


def _run_partitioned_sharded(pool_arrays: dict, jobs: JobArrays, tput,
                             prices, avail, pred, backend, mesh, *,
                             delta_mig=None, collect: bool = False,
                             fallback=None, p_od=None) -> dict:
    """Sharded twin of :func:`_run_partitioned`: partition by kind on the
    host, then lay each partition's (jobs x lanes) grid over ``mesh``.

    Jobs shard the mesh's job axes; on a 2-D ``("jobs", "lanes")`` mesh
    each partition's lane axis also shards over ``"lanes"`` (the kind split
    comes first, so a lane shard is uniformly DP-heavy or cheap). Both axes
    pad to divisibility by repeating the last entry. This rank runs its
    cell; one all-gather over the mesh's ranks brings every cell to every
    rank, which drops the padding and scatter-merges back to pool order."""
    import torch.distributed as dist

    from repro_torch import sharding as shardlib
    from repro_torch.launch.mesh import (all_gather, mesh_coordinates,
                                         pool_mesh_job_axes, rank_device)

    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError(f"pool mesh over {mesh.mesh.numel()} ranks in a "
                         f"world of {dist.get_world_size()}")
    dev = rank_device(mesh)
    jobs_axes, n_jobs_dev, n_lane_dev = pool_mesh_job_axes(mesh)
    n_jobs = int(np.shape(jobs.workload)[0])
    pad_j = (-n_jobs) % n_jobs_dev
    # resolve the logical axes against the mesh (divisibility holds after
    # padding; a non-matching mesh degrades to replication)
    rules = {**shardlib.DEFAULT_RULES, "jobs": jobs_axes}
    jspec = shardlib.resolve_spec(("jobs",), (n_jobs + pad_j,), mesh,
                                  rules)[0]
    n_jb, jb = shardlib.shard_block(jspec, mesh)
    bj = (n_jobs + pad_j) // n_jb
    cut = lambda x: _pad_leading(x, pad_j)[jb * bj:(jb + 1) * bj]
    jobs_c, prices_c, avail_c, pred_c, p_od = _market_to(
        JobArrays(*[cut(f) for f in jobs]), cut(prices), cut(avail),
        cut(pred), p_od, dev)

    ahap_idx, other_idx, ahap_args, cheap_args = _partition_lane_args(
        pool_arrays, with_regions=delta_mig is not None)
    cells, layout = [], []
    for ahap, idx, args in ((True, ahap_idx, ahap_args),
                            (False, other_idx, cheap_args)):
        if not idx.size:
            continue
        p_l = int(idx.size)
        pad_l = (-p_l) % n_lane_dev
        lspec = shardlib.resolve_spec(("lanes",), (p_l + pad_l,), mesh,
                                      rules)[0]
        n_lb, lb = shardlib.shard_block(lspec, mesh)
        bl = (p_l + pad_l) // n_lb
        lane_in = [_pad_leading(a, pad_l)[lb * bl:(lb + 1) * bl]
                   for a in args]
        cells.append(_run_part(ahap, lane_in, jobs_c, tput, prices_c,
                               avail_c, pred_c, backend, dev, delta_mig,
                               collect, fallback, p_od))
        layout.append((idx, p_l, lspec, n_lb))

    # every rank's cells, one collective; rank r's cell sits at its
    # coordinate's (jobs block, lanes block)
    flat = [v for cell in cells for v in cell.values()]
    gathered = all_gather(flat)
    coords = mesh_coordinates(mesh)
    parts, at = [], 0
    for cell, (idx, p_l, lspec, n_lb) in zip(cells, layout):
        keys = list(cell)
        grid = {}
        for rank, items in enumerate(gathered):
            block = (shardlib.shard_block(jspec, mesh, coords[rank])[1],
                     shardlib.shard_block(lspec, mesh, coords[rank])[1])
            grid.setdefault(block, items[at:at + len(keys)])
        at += len(keys)
        parts.append({
            k: torch.cat([torch.cat([grid[(a, b)][i] for b in range(n_lb)],
                                    dim=1) for a in range(n_jb)])[:, :p_l]
            for i, k in enumerate(keys)})
    out = _scatter_merge(parts, [lay[0] for lay in layout], dev)
    if pad_j:
        out = {k: v[:n_jobs] for k, v in out.items()}
    return out


def simulate_pool_jobs_sharded(pool_arrays: dict, jobs: JobArrays,
                               tput: ThroughputConfig, prices, avail, pred,
                               backend: Optional[str] = None, mesh=None,
                               collect: bool = False, fallback=None,
                               device=None) -> dict:
    """:func:`simulate_pool_jobs` with the (jobs x lanes) grid laid over
    ``mesh`` (a pool mesh from ``launch.mesh.make_pool_mesh``; None: the
    1-D pool mesh over the default process group if one is initialized).
    Call it on every rank of the mesh with the same inputs; each rank
    simulates on its own device (``launch.mesh.rank_device``) and returns
    the whole (K, P, ...) result.

    On a 1-D mesh jobs ride the mesh axis and lanes stay whole per rank; a
    2-D ``("jobs", "lanes")`` mesh also shards each kind partition's lane
    axis. Jobs and lanes that do not divide their mesh axis pad by
    repeating the last entry. Per-(job, lane) cells are independent, so
    the result (``collect`` series and the armed ``fallback`` monitor
    included) equals ``simulate_pool_jobs``'s bit for bit. With no process
    group, or a mesh of one rank, this is ``simulate_pool_jobs`` itself
    (``device`` is where it runs when there is no mesh)."""
    from repro_torch.launch.mesh import default_pool_mesh, rank_device

    mesh = default_pool_mesh(device) if mesh is None else mesh
    if mesh is None or mesh.mesh.numel() == 1:
        return simulate_pool_jobs(
            pool_arrays, jobs, tput, prices, avail, pred, backend=backend,
            device=device if mesh is None else rank_device(mesh),
            collect=collect, fallback=fallback)
    return _run_partitioned_sharded(
        pool_arrays, jobs, tput, prices, avail, pred, backend, mesh,
        collect=collect, fallback=fallback)


# ---------------------------------------------------------------------------
# Multi-region lanes (BEYOND-PAPER, SkyNomad arXiv:2601.06520)
# ---------------------------------------------------------------------------
#
# ``simulate_pool_regions`` layers per-slot region selection over the kind-
# partitioned scans: every lane carries a current region, scores all
# regions each slot, switches with a hysteresis margin, pays ``delta_mig``
# zero-allocation slots per switch (checkpoint transfer), and feeds the
# selected region's (price, avail, forecast) into the unchanged decision
# rules. With R == 1 the selector never leaves region 0 and every migration
# branch is a passthrough ``where``, so the shared leaves equal
# ``simulate_pool_jobs``'s bit for bit.

# per-slot region series a collect=True regional run adds: the occupied
# region and the committed switch events
_TEL_REGION = ("tel_region", "tel_migration")

# the pred_horizon score averages a fixed-width forecast window; the python
# reference (policies.RegionSelector.scores) pads / trims to the same width
assert RSEL_PRED_WINDOW == W1MAX


def _mean_last(x):
    """Mean over the last axis in f32, summed left to right then divided by
    the count: the order of the reference's reduction of a W1MAX-wide row
    (and of numpy's for fewer than 8 entries). A region score's mean feeds
    a strict hysteresis test, so its last bit matters."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return exact_div(acc, float(x.shape[-1]))


def _region_scores(n_min, prices, avail, pred):
    """(K, T, N_RSEL, R) lower-better scores from (K, R, T) market data and
    (K, R, T, W1MAX, 2) forecasts: the twin of
    policies.RegionSelector.scores for all four RSEL_* strategies at once
    (lanes gather theirs by ``rsel``). ``n_min`` is the (K,) job field."""
    nmin = n_min[:, None, None]
    big = float(RSEL_BIG)
    price_sc = prices + big * (avail < nmin).to(_F32)        # (K, R, T)
    avail_sc = -avail.to(_F32)
    pdead = (pred[..., 1] < nmin.to(_F32)[..., None]).to(_F32)
    pred_sc = _mean_last(pred[..., 0] + big * pdead)
    sc = torch.stack([torch.zeros_like(price_sc), price_sc, avail_sc,
                      pred_sc], dim=1)                       # (K, 4, R, T)
    return sc.permute(0, 3, 1, 2)


def _region_step(cur, mig_left, sc_row, rmargin, delta_mig: int, inactive):
    """One slot of region selection for (K, P) lanes: argmin with
    hysteresis and migration bookkeeping. ``sc_row`` is (K, P, R) and
    ``rmargin`` (1, P). Returns (cur, mig_left, migrating, switched);
    ``migrating`` slots execute with zero instances (the checkpoint is in
    transit). ``inactive`` lanes (completed, or past their deadline) never
    switch: the reference loop has stopped by then."""
    best = torch.argmin(sc_row, dim=-1)
    cur_sc = torch.gather(sc_row, -1, cur[..., None])[..., 0]
    best_sc = torch.gather(sc_row, -1, best[..., None])[..., 0]
    switch = ((best != cur) & (best_sc + rmargin < cur_sc)
              & (mig_left == 0) & ~inactive)
    cur = torch.where(switch, best, cur)
    mig_left = torch.where(switch, delta_mig,
                           torch.clamp_min(mig_left - 1, 0))
    return cur, mig_left, mig_left > 0, switch


def _at(x, t: int, cur):
    """Slot ``t`` of a (K, R, T) market tensor at each lane's region:
    (K, P)."""
    return torch.gather(x[:, :, t], 1, cur)


def _region_od(j: JobArrays, p_od, cur) -> JobArrays:
    """``j`` with the on-demand price of each lane's region: ``p_o * p_od[cur]``
    (K, P) in f32; unchanged when there are no multipliers."""
    return j if p_od is None else j._replace(p_o=j.p_o * p_od[cur])


def _region_finish(out: dict, cur_hist, sw_hist, keys, tel) -> dict:
    """Add the region leaves (and the collected series) to a lane scan's
    result: ``region`` (K, P, T) i32 and ``migrations`` (K, P) i32."""
    out["region"] = torch.stack(cur_hist, dim=2).to(_I32)
    out["migrations"] = torch.stack(sw_hist, dim=2).to(_I32).sum(
        dim=2, dtype=_I32)
    if keys:
        out.update(_telemetry_out(keys, tel))
    return out


def _simulate_lanes_ahap_regions(omega, v, sigma, rho, rsel, rmargin,
                                 jobs: JobArrays, tput, prices, avail, pred,
                                 backend, device, delta_mig: int,
                                 collect: bool = False, fallback=None,
                                 p_od=None):
    """Region-aware :func:`_simulate_lanes_ahap`: prices/avail are
    (K, R, T), pred (K, R, T, W1MAX, 2). Each slot selects a region per
    lane, gathers that region's AHAP scaffolding (built for every (job,
    region) row, the region's on-demand price in its thresholds) and runs
    the unchanged rule: ONE window solve over the (K * P) rows a slot, each
    row with its region's p_o when ``p_od`` is set.

    ``collect`` adds the ``_TEL_SLOTS`` + ``_TEL_REGION`` series. ``fallback``
    arms the monitor with one error EWMA per lane (K, P): lanes occupy
    different regions, so each scores its region's 1-step-ahead forecast
    against that region's market. ``p_od`` ((R,) f32 multipliers, or None)
    scales the on-demand price by region; termination bills the lane's
    final region."""
    k, r, dmax = prices.shape
    p = omega.shape[0]
    j = _columns(jobs)
    # (job, region) rows of the scaffolding, p_o scaled per region
    jr = JobArrays(*[f[:, None].expand(k, r).reshape(k * r) for f in jobs])
    if p_od is not None:
        jr = jr._replace(p_o=(jobs.p_o[:, None] * p_od[None, :]).reshape(
            k * r))
    jr3 = _columns(jr, 2)
    flat = lambda f: f[:, None].expand(k, p).reshape(k * p)
    rows = _job_cfg(JobArrays(*[flat(f) for f in jobs]))
    sc = _region_scores(jobs.n_min, prices, avail, pred)[:, :, rsel]
    kk = torch.arange(k, device=device)[:, None]
    lane = torch.arange(p, device=device)[None, :]
    z, n_prev, cost, done, T = _init_state(k, p, device)
    plans = torch.zeros((k, p, VMAX, W1MAX, 2), dtype=_F32, device=device)
    cur = torch.argmin(sc[:, 0], dim=-1)        # free initial placement
    mig_left = torch.zeros((k, p), dtype=_I32, device=device)
    margin = rmargin[None, :]
    if fallback is not None:
        thr = _f32(fallback.threshold)
        prev1 = _fallback_prev1(pred.reshape(k * r, dmax, W1MAX, 2)).reshape(
            k, r, dmax, 2)
        prev_av = torch.cat([avail[:, :, :1], avail[:, :, :-1]], dim=2)
        err = torch.zeros((k, p), dtype=_F32, device=device)
        lane_sigma = sigma[None, :]
    no_hist, ns_hist, cur_hist, sw_hist, tel = [], [], [], [], []
    for t in range(dmax):
        cur, mig_left, migrating, switch = _region_step(
            cur, mig_left, sc[:, t], margin, delta_mig,
            done | (t >= j.deadline))
        price, av = _at(prices, t, cur), _at(avail, t, cur)
        j_t = _region_od(j, p_od, cur)
        if p_od is not None:
            rows = dataclasses.replace(rows,
                                       on_demand_price=j_t.p_o.reshape(k * p))
        if fallback is not None:
            # each lane scores its own region's forecast: (K * P) rows
            col = lambda x: x.reshape(k * p, 1)
            err = _fallback_error(fallback, col(err), col(price), col(av),
                                  prev1[kk, cur, t].reshape(k * p, 2)
                                  ).reshape(k, p)
            fb = err > thr
        pr_all, thr_all, zee_all, eff_all = _ahap_precompute(
            jr3, omega, sigma, rho, t, pred[:, :, t].reshape(k * r, W1MAX, 2))
        pr_t = pr_all.reshape(2, k, r, p, W1MAX)[:, kk, cur, lane]
        thr_t = thr_all.reshape(k, r, p, W1MAX)[kk, cur, lane]
        zee_t = zee_all.reshape(k, r, p)[:, 0]
        eff_t = eff_all.reshape(k, r, p)[:, 0]
        n_o, n_s, plans = _ahap_rule_batch(
            rows, j_t, tput, v, backend, device, z, t, price, av, plans,
            pr_t, thr_t, zee_t, eff_t,
        )
        if fallback is not None:
            an_o, an_s = _ahanp_rule(j_t, lane_sigma, z, t, price, av,
                                     n_prev, _at(prev_av, t, cur))
            n_o = torch.where(fb, an_o, n_o)
            n_s = torch.where(fb, an_s, n_s)
        n_o = torch.where(migrating, 0, n_o)
        n_s = torch.where(migrating, 0, n_s)
        n_prev0 = n_prev
        z, n_prev, cost, done, T, n_o, n_s, active = _execute(
            j_t, tput, z, n_prev, cost, done, T, t, n_o, n_s, price, av
        )
        no_hist.append(n_o)
        ns_hist.append(n_s)
        cur_hist.append(cur)
        sw_hist.append(switch)
        if collect:
            sample = _slot_telemetry(j_t, n_prev0, z, n_o, n_s, active, price,
                                     av) + (cur.to(_I32), switch)
            if fallback is not None:
                sample += (fb, err)
            tel.append(sample)
    out = _finalize(_region_od(j, p_od, cur), tput, z, cost, done, T,
                    no_hist, ns_hist)
    keys = ()
    if collect:
        keys = (_TEL_SLOTS + _TEL_REGION
                + (_TEL_FALLBACK if fallback is not None else ()))
    return _region_finish(out, cur_hist, sw_hist, keys, tel)


def _simulate_one_cheap_regions(kind, sigma, cfrac, rsel, rmargin,
                                jobs: JobArrays, tput, prices, avail, pred,
                                delta_mig: int, collect: bool = False,
                                fallback=None, p_od=None):
    """Region-aware :func:`_simulate_one_cheap`: the same DP-free rules fed
    each lane's selected region's (price, avail). ``collect`` adds the
    ``_TEL_SLOTS`` + ``_TEL_REGION`` series; cheap lanes read no
    forecasts, so ``fallback`` (with collect) only adds the all-zero
    ``_TEL_FALLBACK`` placeholders. ``p_od`` scales the on-demand price by
    the occupied region, as in :func:`_simulate_lanes_ahap_regions`."""
    k, r, dmax = prices.shape
    p = kind.shape[0]
    dev = prices.device
    j = _columns(jobs)
    kind, sigma, cfrac = kind[None, :], sigma[None, :], cfrac[None, :]
    sc = _region_scores(jobs.n_min, prices, avail, pred)[:, :, rsel]
    z, n_prev, cost, done, T = _init_state(k, p, dev)
    cur = torch.argmin(sc[:, 0], dim=-1)
    prev_avail = _at(avail, 0, cur)
    mig_left = torch.zeros((k, p), dtype=_I32, device=dev)
    margin = rmargin[None, :]
    no_hist, ns_hist, cur_hist, sw_hist, tel = [], [], [], [], []
    for t in range(dmax):
        cur, mig_left, migrating, switch = _region_step(
            cur, mig_left, sc[:, t], margin, delta_mig,
            done | (t >= j.deadline))
        price, av = _at(prices, t, cur), _at(avail, t, cur)
        j_t = _region_od(j, p_od, cur)
        n_o, n_s = _cheap_rules(kind, sigma, cfrac, j_t, tput, z, t, price,
                                av, n_prev, prev_avail)
        n_o = torch.where(migrating, 0, n_o)
        n_s = torch.where(migrating, 0, n_s)
        n_prev0 = n_prev
        z, n_prev, cost, done, T, n_o, n_s, active = _execute(
            j_t, tput, z, n_prev, cost, done, T, t, n_o, n_s, price, av
        )
        prev_avail = torch.where(active, av, prev_avail)
        no_hist.append(n_o)
        ns_hist.append(n_s)
        cur_hist.append(cur)
        sw_hist.append(switch)
        if collect:
            sample = _slot_telemetry(j_t, n_prev0, z, n_o, n_s, active, price,
                                     av) + (cur.to(_I32), switch)
            if fallback is not None:
                sample += (torch.zeros_like(switch),
                           torch.zeros_like(z))
            tel.append(sample)
    out = _finalize(_region_od(j, p_od, cur), tput, z, cost, done, T,
                    no_hist, ns_hist)
    keys = ()
    if collect:
        keys = (_TEL_SLOTS + _TEL_REGION
                + (_TEL_FALLBACK if fallback is not None else ()))
    return _region_finish(out, cur_hist, sw_hist, keys, tel)


def simulate_pool_regions(pool_arrays: dict, jobs: JobArrays,
                          tput: ThroughputConfig, prices, avail, pred,
                          backend: Optional[str] = None, device=None, *,
                          delta_mig: int, collect: bool = False,
                          fallback=None, p_od=None) -> dict:
    """Multi-region :func:`simulate_pool_jobs`: jobs x pool over an R-region
    market. ``prices``/``avail`` are (K, R, d_max), ``pred``
    (K, R, d_max, W1MAX, 2) (see :func:`prepare_inputs_regions`);
    ``delta_mig`` is the checkpoint-transfer cost in lost slots (required:
    pass ``market.delta_mig``). Lanes read their region strategy from the
    pool's ``rsel`` / ``rmargin`` (policy_pool.region_pool; absent keys
    mean every lane stays put).

    Returns the ``simulate_pool_jobs`` leaves (K, P, ...) plus ``region``
    (each lane's region each slot) and ``migrations`` (committed switches).
    With R == 1 the shared leaves equal ``simulate_pool_jobs``'s bit for
    bit. The AHAP lanes issue ONE window solve a slot (one K1 launch on the
    card). ``collect=True`` adds the (K, P, T) ``tel_*`` series with
    ``tel_region`` / ``tel_migration`` (obs.ledger.migration_reconciliation
    reconciles them); ``fallback`` arms the AHAP lanes' per-lane monitor;
    ``p_od`` (scalar or (R,)) multiplies the jobs' on-demand price by the
    occupied region (``market.p_od``)."""
    dev = resolve_device(device)
    jobs, prices, avail, pred, p_od = _market_to(jobs, prices, avail, pred,
                                                 p_od, dev)
    return _run_partitioned(pool_arrays, jobs, tput, prices, avail, pred,
                            backend, dev, int(delta_mig), collect, fallback,
                            p_od)


def simulate_pool_regions_sharded(pool_arrays: dict, jobs: JobArrays,
                                  tput: ThroughputConfig, prices, avail,
                                  pred, backend: Optional[str] = None, *,
                                  delta_mig: int, mesh=None,
                                  collect: bool = False, fallback=None,
                                  p_od=None, device=None) -> dict:
    """:func:`simulate_pool_regions` over the pool mesh: jobs (and, on a
    2-D mesh, lanes) shard exactly as in :func:`simulate_pool_jobs_sharded`;
    the small region axis rides along whole in each rank's (K, R, T) market
    (``p_od`` is given to every rank). Equal to ``simulate_pool_regions``
    bit for bit, ``collect`` / ``fallback`` / ``p_od`` included; with no
    process group, or a mesh of one rank, it is that function."""
    from repro_torch.launch.mesh import default_pool_mesh, rank_device

    mesh = default_pool_mesh(device) if mesh is None else mesh
    if mesh is None or mesh.mesh.numel() == 1:
        return simulate_pool_regions(
            pool_arrays, jobs, tput, prices, avail, pred, backend=backend,
            device=device if mesh is None else rank_device(mesh),
            delta_mig=delta_mig, collect=collect, fallback=fallback,
            p_od=p_od)
    return _run_partitioned_sharded(
        pool_arrays, jobs, tput, prices, avail, pred, backend, mesh,
        delta_mig=int(delta_mig), collect=collect, fallback=fallback,
        p_od=p_od)


# ---------------------------------------------------------------------------
# The seed path: every lane runs every rule (benchmark baseline and the
# partitioned path's equivalence oracle)
# ---------------------------------------------------------------------------

def _simulate_lanes_monolithic(kind, omega, v, sigma, rho, cfrac,
                               jobs: JobArrays, tput, prices, avail, pred,
                               backend, device):
    """The seed formulation over (K jobs, P lanes): every lane runs all six
    decision rules every slot, the window solve included (ONE solve over
    the (K * P) rows a slot: one K1 launch on the card), and takes its
    ``kind``'s decision. Lane parameters are (P,) tensors."""
    k, dmax = prices.shape
    p = kind.shape[0]
    j, j3 = _columns(jobs), _columns(jobs, 2)
    rows = _job_cfg(JobArrays(*[f[:, None].expand(k, p).reshape(k * p)
                                for f in jobs]))
    lane_kind, lane_sigma, lane_cfrac = kind[None], sigma[None], cfrac[None]
    z, n_prev, cost, done, T = _init_state(k, p, device)
    plans = torch.zeros((k, p, VMAX, W1MAX, 2), dtype=_F32, device=device)
    prev_avail = avail[:, :1].expand(k, p)
    no_hist, ns_hist = [], []
    for t in range(dmax):
        price, av = prices[:, t:t + 1], avail[:, t:t + 1]
        pr_t, thr_t, zee_t, eff_t = _ahap_precompute(
            j3, omega, sigma, rho, t, pred[:, t])
        ah_o, ah_s, plans = _ahap_rule_batch(
            rows, j, tput, v, backend, device, z, t, price, av, plans,
            pr_t, thr_t, zee_t, eff_t)
        n_o, n_s = _cheap_rules(lane_kind, lane_sigma, lane_cfrac, j, tput,
                                z, t, price, av, n_prev, prev_avail)
        n_o = torch.where(lane_kind == KIND_AHAP, ah_o, n_o)
        n_s = torch.where(lane_kind == KIND_AHAP, ah_s, n_s)
        z, n_prev, cost, done, T, n_o, n_s, active = _execute(
            j, tput, z, n_prev, cost, done, T, t, n_o, n_s, price, av)
        prev_avail = torch.where(active, av, prev_avail)
        no_hist.append(n_o)
        ns_hist.append(n_s)
    return _finalize(j, tput, z, cost, done, T, no_hist, ns_hist)


def simulate_pool_jobs_monolithic(pool_arrays: dict, jobs: JobArrays,
                                  tput: ThroughputConfig, prices, avail,
                                  pred, backend: Optional[str] = None,
                                  device=None) -> dict:
    """The seed path over K jobs: every lane of the pool runs every rule
    (the window DP included, one K1 launch a slot over all (K * P) rows)
    and selects by kind. Inputs as :func:`simulate_pool_jobs`; returns
    the same (K, P, ...) leaves in pool order, equal to its bit for bit."""
    dev = resolve_device(device)
    jobs, prices, avail, pred, _ = _market_to(jobs, prices, avail, pred,
                                              None, dev)
    arr = {k: _host(v) for k, v in pool_arrays.items()}
    n = len(arr["kind"])
    lane = lambda key, default, dt: to_device(arr.get(key, default), dt, dev)
    return _simulate_lanes_monolithic(
        lane("kind", None, _I32), lane("omega", None, _I32),
        lane("v", None, _I32), lane("sigma", None, _F32),
        lane("rho", np.ones(n, np.float32), _F32),
        lane("cfrac", np.zeros(n, np.float32), _F32),
        jobs, tput, prices, avail, pred, backend, dev)


def _one_job(j: JobArrays, prices, avail, pred):
    """One job's scalar leaves and (d_max, ...) market as a K = 1 batch."""
    return (JobArrays(*[np.asarray(_host(f))[None] for f in j]),
            _host(prices)[None], _host(avail)[None], _host(pred)[None])


def simulate_pool_monolithic(pool_arrays: dict, j: JobArrays,
                             tput: ThroughputConfig, prices, avail, pred,
                             backend: Optional[str] = None,
                             device=None) -> dict:
    """The seed path for one job (``j`` scalar leaves, prices / avail
    (d_max,), pred (d_max, W1MAX, 2)): every lane runs every rule and
    selects by kind. The perf baseline and the parity cross-check of the
    partitioned :func:`simulate_pool`; (P, ...) leaves in pool order."""
    jobs, prices, avail, pred = _one_job(j, prices, avail, pred)
    out = simulate_pool_jobs_monolithic(pool_arrays, jobs, tput, prices,
                                        avail, pred, backend=backend,
                                        device=device)
    return {k: v[0] for k, v in out.items()}


def simulate_one(kind, omega, v, sigma, j: JobArrays, tput, prices, avail,
                 pred, rho=1.0, cfrac=0.0, backend: Optional[str] = None,
                 device=None) -> dict:
    """One lane of the seed path (scalar policy encoding, one job): all six
    rules every slot, selected by ``kind``. Returns per-lane scalars and
    (d_max,) allocation histories."""
    pool = {"kind": [kind], "omega": [omega], "v": [v], "sigma": [sigma],
            "rho": [rho], "cfrac": [cfrac]}
    out = simulate_pool_monolithic(pool, j, tput, prices, avail, pred,
                                   backend=backend, device=device)
    return {k: v_[0] for k, v_ in out.items()}


def _simulate_one_ahap(omega, v, sigma, rho, j: JobArrays, tput, prices,
                       avail, pred, backend: Optional[str] = None,
                       device=None) -> dict:
    """One AHAP lane of one job, the pre-batching formulation: the lane's
    scaffolding for every slot (rho-discounted forecasts, threshold plans,
    schedule line, effective window lengths) built once before the loop,
    then the batched rule at P = 1 each slot. Over lanes it is the
    equivalence oracle of :func:`_simulate_lanes_ahap`."""
    dev = resolve_device(device)
    jobs, prices, avail, pred = _one_job(j, prices, avail, pred)
    jobs, prices, avail, pred, _ = _market_to(jobs, prices, avail, pred,
                                              None, dev)
    scalar = lambda x, dt: to_device(np.asarray(_host(x)).reshape(1), dt,
                                     dev)
    omega, v = scalar(omega, _I32), scalar(v, _I32)
    sigma, rho = scalar(sigma, _F32), scalar(rho, _F32)
    dmax = prices.shape[1]
    jc, j3 = _columns(jobs), _columns(jobs, 2)
    # every slot at once: the slots ride the job axis of _ahap_precompute
    ts = torch.arange(dmax, dtype=_I32, device=dev)[:, None]
    pr, thr_s, z_exp_end, eff_slots = _ahap_precompute(j3, omega, sigma,
                                                       rho, ts, pred[0])
    z, n_prev, cost, done, T = _init_state(1, 1, dev)
    plans = torch.zeros((1, 1, VMAX, W1MAX, 2), dtype=_F32, device=dev)
    no_hist, ns_hist = [], []
    for t in range(dmax):
        price, av = prices[:, t:t + 1], avail[:, t:t + 1]
        n_o, n_s, plans = _ahap_rule_batch(
            _job_cfg(jobs), jc, tput, v, backend, dev, z, t, price, av,
            plans, pr[:, t:t + 1], thr_s[t:t + 1], z_exp_end[t:t + 1],
            eff_slots[t:t + 1])
        z, n_prev, cost, done, T, n_o, n_s, _ = _execute(
            jc, tput, z, n_prev, cost, done, T, t, n_o, n_s, price, av)
        no_hist.append(n_o)
        ns_hist.append(n_s)
    out = _finalize(jc, tput, z, cost, done, T, no_hist, ns_hist)
    return {k: v_[0, 0] for k, v_ in out.items()}


def prepare_inputs(trace, pred_matrix, d_max: int):
    """Pad/trim a trace + prediction matrix to (d_max, ...) numpy arrays:
    prices f32, avail i32, pred (d_max, W1MAX, 2) f32 (None broadcasts the
    observed present)."""
    prices = np.asarray(trace.prices[:d_max], np.float32)
    avail = np.asarray(trace.avail[:d_max], np.int32)
    if pred_matrix is None:
        pm = np.zeros((d_max, W1MAX, 2), np.float32)
        pm[:, :, 0] = np.asarray(trace.prices[:d_max])[:, None]
        pm[:, :, 1] = np.asarray(trace.avail[:d_max])[:, None]
    else:
        pm = np.asarray(pred_matrix[:d_max, :W1MAX], np.float32)
        if pm.shape[1] < W1MAX:
            pad = np.repeat(pm[:, -1:], W1MAX - pm.shape[1], axis=1)
            pm = np.concatenate([pm, pad], axis=1)
    return prices, avail, pm


def prepare_inputs_regions(market, pred_matrix, d_max: int):
    """Regional :func:`prepare_inputs`: (R, d_max) prices f32 / avail i32
    and an (R, d_max, W1MAX, 2) f32 prediction stack (pad / trim per
    region; None broadcasts the observed present), as numpy arrays."""
    prices = np.asarray(market.prices[:, :d_max], np.float32)
    avail = np.asarray(market.avail[:, :d_max], np.int32)
    if pred_matrix is None:
        pm = np.zeros(market.prices[:, :d_max].shape + (W1MAX, 2), np.float32)
        pm[..., 0] = np.asarray(market.prices[:, :d_max])[..., None]
        pm[..., 1] = np.asarray(market.avail[:, :d_max])[..., None]
    else:
        pm = np.asarray(pred_matrix[:, :d_max, :W1MAX], np.float32)
        if pm.shape[2] < W1MAX:
            pad = np.repeat(pm[:, :, -1:], W1MAX - pm.shape[2], axis=2)
            pm = np.concatenate([pm, pad], axis=2)
    return prices, avail, pm
