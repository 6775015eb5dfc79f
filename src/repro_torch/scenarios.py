"""The two stress workloads of the selection path: the chaos sweep's forced
storm regime and the scenario grid's 48 market regimes.

Copied from the JAX package's ``benchmarks/chaos_sweep.py``
(``build_inputs``) and ``benchmarks/scenario_grid.py`` (``grid_regimes``,
``build_grid_inputs``, ``evaluate_grid``), which import the reference
package; the inputs are bit-equal to theirs on the same seeds. Both run
the 124-lane pool through ``engine.simulate_and_select``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.chaos import inject, storm_schedule
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import engine, fast_sim
from repro_torch.core.market import from_arrays
from repro_torch.data.synthetic import market_regime_batch
from repro_torch.workload import PAPER_TPUT, job_stream_arrays, paper_market

# ---- the chaos sweep's forced storm regime: an abundant, cheap pre-storm
# market (so stale forecasts are rosy), deadline-tight workloads (storm
# slots lost to phantom-spot deferral are unrecoverable) and preemption
# storms with price spikes aligned with a frozen ("stale") predictor ----
CHAOS_MARKET_SEED = 11
CHAOS_JOB_SEED = 3
CHAOS_FAULT_SEED = 11
CHAOS_DEADLINE = 10
CHAOS_WORKLOAD_SCALE = 1.4
CHAOS_NOISE = ("magdep_uniform", 0.1)
CHAOS_MARKET_KW = dict(avail_mean=9.0, mean_price=0.4, price_sigma=0.3)
CHAOS_STORM_LEN = 4
CHAOS_SPIKE_MAG = 2.5
CHAOS_PRED_FAULT = "stale"
# the bench's monitor: lam 0.5 arms within one storm slot and disarms
# within a few clean ones, both edges inside a 10-slot window
CHAOS_THRESHOLD = 0.5
CHAOS_LAM = 0.5


def chaos_inputs(n_storms: int, n_jobs: int):
    """Engine inputs for one fault intensity: the clean per-job windows,
    faulted by one ``storm_schedule`` at window-relative slots, so every
    job rides through the same storms. Returns ``(jobs, prices, avail,
    preds, schedule)`` (numpy)."""
    rng = np.random.default_rng(CHAOS_JOB_SEED)
    jobs = job_stream_arrays(rng, n_jobs, deadline=CHAOS_DEADLINE,
                             workload_scale=CHAOS_WORKLOAD_SCALE)
    trace = paper_market(CHAOS_MARKET_SEED, **CHAOS_MARKET_KW)
    t0s = np.random.default_rng(CHAOS_JOB_SEED + 1).integers(
        0, len(trace) - CHAOS_DEADLINE - 1, n_jobs)
    pw, aw, preds = engine.prepare_noisy_inputs(
        trace, t0s, CHAOS_DEADLINE, *CHAOS_NOISE,
        CHAOS_JOB_SEED * 100003 + np.arange(n_jobs))
    sched = storm_schedule(CHAOS_FAULT_SEED, pw.shape[1], n_storms=n_storms,
                           storm_len=CHAOS_STORM_LEN,
                           spike_mag=CHAOS_SPIKE_MAG,
                           pred_fault=CHAOS_PRED_FAULT)
    pw, aw, preds = inject(pw, aw, preds, sched)
    return jobs, pw, aw, preds, sched


# ---- the scenario grid: availability x price volatility x deadline
# tightness x restart overhead x forecast noise; every regime shares the
# market seed and paper_market's scarce-regime price level ----
GRID_AVAIL = (3.5, 5.5, 9.0)
GRID_SIGMA = (0.25, 0.5)
GRID_TIGHT = (0.8, 1.15)
GRID_MU = ((0.9, 0.95), (0.7, 0.85))
GRID_NOISE = (0.0, 0.3)
GRID_JOBS = 16
GRID_MARKET_SEED = 11
GRID_DAYS = 4.0
GRID_JOB_SEED = 7
GRID_DEADLINE = 10
GRID_NOISE_KIND = "fixed_uniform"
GRID_MEAN_PRICE = 0.7
GRID_AVAIL_SEASON_AMP = 3.0


@dataclass(frozen=True)
class Regime:
    avail_mean: float
    price_sigma: float
    tight: float          # workload scale (deadline tightness)
    mu1: float
    mu2: float
    noise: float          # forecast noise level (fixed_uniform)

    @property
    def key(self) -> str:
        return (f"a{self.avail_mean:g}_s{self.price_sigma:g}"
                f"_t{self.tight:g}_m{self.mu1:g}_n{self.noise:g}")

    @property
    def tput(self) -> ThroughputConfig:
        return ThroughputConfig(alpha=PAPER_TPUT.alpha, beta=PAPER_TPUT.beta,
                                mu1=self.mu1, mu2=self.mu2)


def grid_regimes(
    avail: Sequence[float] = GRID_AVAIL,
    sigma: Sequence[float] = GRID_SIGMA,
    tight: Sequence[float] = GRID_TIGHT,
    mu: Sequence[Tuple[float, float]] = GRID_MU,
    noise: Sequence[float] = GRID_NOISE,
) -> List[Regime]:
    """The cartesian grid, mu-major: each distinct (mu1, mu2) is one
    contiguous block of regimes, one engine call."""
    return [
        Regime(a, s, t, m1, m2, nz)
        for (m1, m2) in mu
        for a in avail
        for s in sigma
        for t in tight
        for nz in noise
    ]


def grid_inputs(regimes: List[Regime], n_jobs: int = GRID_JOBS):
    """Regime-major stacked engine inputs for the whole grid: one
    ``market_regime_batch`` call, one concatenated trace so the window
    gather and the forecast stack are ONE ``prepare_noisy_inputs`` call
    (per-regime noise levels on its per-row ``level``), and one
    ``concat_jobs`` stack of per-regime job blocks. Base job draws, window
    starts and noise seeds are shared across regimes. Returns ``(jobs
    (R*K,), prices (R*K, d), avail (R*K, d), preds (R*K, d, W1MAX, 2))``
    (numpy)."""
    r = len(regimes)
    prices_r, avail_r = market_regime_batch(
        np.full(r, GRID_MARKET_SEED, np.int64),
        days=GRID_DAYS,
        mean_price=GRID_MEAN_PRICE,
        price_sigma=[g.price_sigma for g in regimes],
        avail_mean=[g.avail_mean for g in regimes],
        avail_season_amp=GRID_AVAIL_SEASON_AMP,
    )
    t = prices_r.shape[1]
    # windows never cross a regime boundary (t0 <= T - d - 1 within each)
    cat = from_arrays(prices_r.reshape(-1), avail_r.reshape(-1))
    t0s = np.random.default_rng(GRID_JOB_SEED + 1).integers(
        0, t - GRID_DEADLINE - 1, n_jobs)
    t0s_all = (np.arange(r)[:, None] * t + t0s[None, :]).reshape(-1)
    seeds = GRID_JOB_SEED * 100003 + np.arange(n_jobs)
    prices, avail, preds = engine.prepare_noisy_inputs(
        cat, t0s_all, GRID_DEADLINE, GRID_NOISE_KIND,
        np.repeat([g.noise for g in regimes], n_jobs), np.tile(seeds, r))
    jobs = fast_sim.concat_jobs([
        job_stream_arrays(np.random.default_rng(GRID_JOB_SEED), n_jobs,
                          GRID_DEADLINE, workload_scale=g.tight)
        for g in regimes
    ])
    return jobs, prices, avail, preds


def evaluate_grid(pool_arrays: dict, regimes: List[Regime], jobs, prices,
                  avail, preds, n_jobs: int = GRID_JOBS, *, device=None,
                  collect: bool = False):
    """The stacked grid through the engine: one ``simulate_and_select``
    call per contiguous mu block (the throughput config is per call),
    covering every regime of the block on the jobs axis. Returns ``(util
    (R, K, M) f32, sim_out)``: the raw utilities in regime order and, with
    ``collect``, the merged flight-recorder dict ((R*K, M, ...) numpy,
    regime-major; else None)."""
    r = len(regimes)
    m = int(np.shape(pool_arrays["kind"])[0])
    util = np.empty((r, n_jobs, m), np.float32)
    sim_chunks = []
    lo = 0
    while lo < r:
        hi = lo + 1
        while hi < r and (regimes[hi].mu1, regimes[hi].mu2) == (
                regimes[lo].mu1, regimes[lo].mu2):
            hi += 1
        a, b = lo * n_jobs, hi * n_jobs
        res = engine.simulate_and_select(
            pool_arrays, fast_sim.slice_jobs(jobs, a, b), regimes[lo].tput,
            prices[a:b], avail[a:b], preds[a:b], device=device,
            return_utilities=True, collect=collect)
        util[lo:hi] = res.utilities.reshape(hi - lo, n_jobs, m)
        if collect:
            sim_chunks.append(res.sim_out)
        lo = hi
    sim_out = None
    if collect:
        sim_out = {k: np.concatenate([c[k] for c in sim_chunks])
                   for k in sim_chunks[0]}
    return util, sim_out


def grid_winners(util: np.ndarray):
    """(winner lane per regime (R,), the best fixed lane over the grid):
    argmax of the per-regime mean utility, and of its mean over regimes."""
    mean_u = util.mean(axis=1)                      # (R, M)
    return mean_u.argmax(axis=1), int(mean_u.mean(axis=0).argmax())
