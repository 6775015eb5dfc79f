"""The port's region-aware pool simulator (``fast_sim.simulate_pool_regions``)
against the JAX package's compiled one, against the port's single-region
path at R = 1, and against the port's python regional oracle
(``region_market.simulate_regional``); plus the reference's hand-checked
toy markets (migration cost, per-region on-demand price, hysteresis, free
moves, no moves after completion or deadline, forecast scoring).

Region paths, migrations and allocations are exact; f32 costs and
utilities are held to ROADMAP Queue 3, entry 3 (rtol 1e-5, atol 1e-4)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.chaos import FallbackConfig as RefFallback
from repro.configs.base import ThroughputConfig as RefTput
from repro.core import fast_sim as ref_fs
from repro.core import policy_pool as ref_pool
from repro.core.predictor import NoisyPredictor as RefNoisy
from repro.core.predictor import RegionalPredictor as RefRegional
from repro.core.region_market import vast_like_regions as ref_regions
from repro_torch.chaos import FallbackConfig
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core import fast_sim
from repro_torch.core.market import from_arrays, vast_like_trace
from repro_torch.core.policies import RSEL_AVAIL, RSEL_PRED, RSEL_PRICE
from repro_torch.core.policy_pool import (KIND_MSU, PolicySpec,
                                          baseline_specs, paper_pool,
                                          rand_deadline_pool, region_pool,
                                          specs_to_arrays)
from repro_torch.core.predictor import NoisyPredictor, RegionalPredictor
from repro_torch.core.region_market import (RegionalMarket,
                                            simulate_regional,
                                            vast_like_regions)
from repro_torch.workload import job_stream_arrays

torch.set_num_threads(2)

JOB = JobConfig(workload=80, deadline=10, n_min=1, n_max=12, value=120.0)
TPUT = ThroughputConfig(mu1=0.9, mu2=0.95)
REF_TPUT = RefTput(**dataclasses.asdict(TPUT))
# ROADMAP Queue 3, entry 3
RTOL, ATOL = 1e-5, 1e-4
INT_KEYS = ("n_od", "n_spot", "region", "migrations", "completed",
            "tel_active", "tel_up", "tel_down", "tel_preempt", "tel_region",
            "tel_migration", "tel_fallback")


def _run(arrs, jobs, prices, avail, pred, **kw):
    """The port on the CPU, results as numpy."""
    out = fast_sim.simulate_pool_regions(arrs, jobs, TPUT, prices, avail,
                                         pred, device="cpu", **kw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_matches(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if k in INT_KEYS:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)


def _regional_inputs(n_jobs, seed, level, avail_mean=5.5, d=10):
    """(jobs, prices (K, R, d), avail, pred (K, R, d, W1MAX, 2)) from the
    reference's generators: 3 phase-shifted regions, one noisy forecast
    stack per (job, region), the job stream of the selection benchmarks."""
    mkt = ref_regions(3, seed=seed, days=2, phase_hours=(0.0, 8.0, 16.0),
                      avail_mean=avail_mean, avail_season_amp=3.0)
    rng = np.random.default_rng(seed)
    jobs = job_stream_arrays(rng, n_jobs, d)
    t0s = rng.integers(0, len(mkt) - d - 1, n_jobs)
    parts = []
    for k, t0 in enumerate(t0s):
        w = mkt.window(int(t0), d + 1)
        pm = RefRegional(w, lambda tr, r, k=k: RefNoisy(
            tr, "fixed_uniform", level, seed=k * 1009 + r)).matrix(
                fast_sim.W1MAX - 1)
        parts.append([np.asarray(x) for x in
                      ref_fs.prepare_inputs_regions(w, pm, d)])
    prices, avail, pred = (np.stack(x) for x in zip(*parts))
    return jobs, prices, avail, pred


@pytest.mark.parametrize("case", [
    dict(),
    dict(p_od=(1.0, 1.3, 0.8)),
    dict(collect=True),
    dict(collect=True, p_od=(1.0, 2.0, 0.7),
         fallback=(0.15, 0.25, 0.3)),
    dict(fallback=(0.15, 0.5, 0.5), scarce=True),
], ids=["flat", "p_od", "collect", "collect-p_od-fallback",
        "fallback-scarce"])
def test_region_scans_match_reference(case):
    """The port against ``jax.jit`` of the reference's region scans on the
    36-lane region pool plus every cheap kind: flat, per-region on-demand
    multipliers, the flight recorder, the per-lane monitor, and a scarce
    market whose forecasts often price regions out (RSEL_BIG ties)."""
    case = dict(case)
    jobs, prices, avail, pred = _regional_inputs(
        8, 3, 0.3, avail_mean=2.5 if case.pop("scarce", False) else 5.5)
    fb = case.pop("fallback", None)
    ref_specs = ref_pool.region_pool() + ref_pool.rand_deadline_pool((0.3,))
    specs = region_pool() + rand_deadline_pool((0.3,))
    ref_kw, kw = dict(case), dict(case)
    if fb is not None:
        ref_kw["fallback"] = RefFallback(*fb)
        kw["fallback"] = FallbackConfig(*fb)
    want = ref_fs.simulate_pool_regions(
        ref_pool.specs_to_arrays(ref_specs), jobs, REF_TPUT, prices, avail,
        pred, delta_mig=1, **ref_kw)
    got = _run(specs_to_arrays(specs), jobs, prices, avail, pred,
               delta_mig=1, **kw)
    _assert_matches(got, want)
    if fb is not None and case.get("collect"):
        assert got["tel_fallback"].any() and not got["tel_fallback"].all()
    assert got["migrations"].sum() > 0


def test_r1_bit_equal_to_single_region_path():
    """With one region every simulate_pool_jobs leaf comes out of the
    region scans unchanged, bit for bit, and no lane migrates."""
    specs = (paper_pool(omegas=(1, 3, 5), sigmas=(0.3, 0.7))
             + rand_deadline_pool((0.2, 0.6)) + baseline_specs())
    arrs = specs_to_arrays(specs)
    jobs = fast_sim.stack_jobs([JOB, JobConfig(workload=100, deadline=10,
                                               n_min=2, n_max=14,
                                               value=120.0)])
    single, regional = [], []
    for seed in range(2):
        tr = vast_like_trace(seed=30 + seed, days=1).window(0, 10)
        pred = NoisyPredictor(tr, "fixed_uniform", 0.2, seed=seed).matrix(
            fast_sim.W1MAX - 1)
        single.append(fast_sim.prepare_inputs(tr, pred, JOB.deadline))
        regional.append(fast_sim.prepare_inputs_regions(
            RegionalMarket.from_traces([tr]), pred[None], JOB.deadline))
    for collect in (False, True):
        a = fast_sim.simulate_pool_jobs(
            arrs, jobs, TPUT, *(np.stack(x) for x in zip(*single)),
            device="cpu", collect=collect)
        b = _run(arrs, jobs, *(np.stack(x) for x in zip(*regional)),
                 delta_mig=1, collect=collect)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
        assert not b["migrations"].any() and not b["region"].any()


def _market(seed=1):
    mkt = vast_like_regions(3, seed=seed, days=1).window(0, 11)
    rpred = RegionalPredictor(
        mkt, lambda t, r: NoisyPredictor(t, "fixed_uniform", 0.2, seed=r)
    ).matrix(fast_sim.W1MAX - 1)
    return mkt, rpred


@pytest.mark.parametrize("seed,p_od", [(1, None), (2, (1.0, 2.0, 0.8))])
def test_region_lanes_match_python_oracle(seed, p_od):
    """Every region_pool lane against the port's python regional simulator
    (simulate_regional + the lane's build() / build_selector()): region
    path up to completion, migrations, allocations exact, utility to
    Queue 3, entry 3."""
    mkt, rpred = _market(seed)
    mkt.p_od = None if p_od is None else np.asarray(p_od, np.float64)
    pool = region_pool()
    rp, ra, rpm = fast_sim.prepare_inputs_regions(mkt, rpred, JOB.deadline)
    out = _run(specs_to_arrays(pool), fast_sim.stack_jobs([JOB]), rp[None],
               ra[None], rpm[None], delta_mig=mkt.delta_mig, p_od=p_od)
    for i, spec in enumerate(pool):
        r = simulate_regional(spec.build(device="cpu"), spec.build_selector(),
                              JOB, TPUT, mkt, rpm)
        assert r.migrations == int(out["migrations"][0, i]), spec.name
        done_at = len(r.region_hist)
        if r.completed_by_deadline:
            done_at = int(np.ceil(r.completion_time))
        np.testing.assert_array_equal(out["region"][0, i, :done_at],
                                      r.region_hist[:done_at],
                                      err_msg=spec.name)
        np.testing.assert_array_equal(out["n_spot"][0, i], r.n_spot,
                                      err_msg=spec.name)
        np.testing.assert_array_equal(out["n_od"][0, i], r.n_od,
                                      err_msg=spec.name)
        np.testing.assert_allclose(out["utility"][0, i], r.utility,
                                   rtol=RTOL, atol=ATOL, err_msg=spec.name)


def _two_region(p0, p1, av0, av1=None, delta_mig=1, p_od=None):
    av1 = av0 if av1 is None else av1
    return RegionalMarket.from_traces(
        [from_arrays(np.asarray(p0), np.asarray(av0, np.int64)),
         from_arrays(np.asarray(p1), np.asarray(av1, np.int64))],
        delta_mig=delta_mig, p_od=p_od)


def _toy(mkt, specs, job, tput=TPUT, pred=None, p_od=None, jobs=None):
    d = len(mkt) if jobs is None else max(j.deadline for j in jobs)
    rp, ra, rpm = fast_sim.prepare_inputs_regions(mkt, pred, d)
    jobs = [job] if jobs is None else jobs
    tile = lambda x: np.repeat(x[None], len(jobs), axis=0)
    out = fast_sim.simulate_pool_regions(
        specs_to_arrays(specs), fast_sim.stack_jobs(jobs), tput, tile(rp),
        tile(ra), tile(rpm), device="cpu", delta_mig=mkt.delta_mig,
        p_od=p_od)
    return {k: v.numpy() for k, v in out.items()}


def test_migration_cost_accounting_two_region_toy():
    """MSU@greedy_price rides region 0's cheap spot for 4 slots, pays one
    delta_mig slot (zero instances, zero billing) to move, then rides
    region 1; cost and progress as derived by hand, and the oracle
    agrees."""
    job = JobConfig(workload=200.0, deadline=8, n_min=1, n_max=4, value=120.0)
    tput = ThroughputConfig(alpha=1.0, beta=0.0, mu1=0.9, mu2=0.95)
    mkt = _two_region([0.2] * 4 + [0.9] * 4, [0.8] * 4 + [0.3] * 4,
                      np.full(8, 4))
    spec = PolicySpec(KIND_MSU, rsel=RSEL_PRICE, rmargin=0.0)
    out = _toy(mkt, [spec], job, tput)
    np.testing.assert_array_equal(out["region"][0, 0], [0] * 4 + [1] * 4)
    np.testing.assert_array_equal(out["n_spot"][0, 0],
                                  [4, 4, 4, 4, 0, 4, 4, 4])
    assert int(out["migrations"][0, 0]) == 1
    z_exp = 15.6 + 0.0 + 11.6
    assert abs(float(out["z_ddl"][0, 0]) - z_exp) < 1e-4
    run_cost = 4 * 4 * 0.2 + 3 * 4 * 0.3
    term_cost = job.on_demand_price * job.n_max * (job.workload - z_exp) / 4.0
    assert abs(float(out["cost"][0, 0]) - (run_cost + term_cost)) < 1e-3
    ref = simulate_regional(spec.build(), spec.build_selector(), job, tput,
                            mkt, None)
    assert ref.migrations == 1
    assert abs(ref.cost - (run_cost + term_cost)) < 1e-3


def test_per_region_od_price_two_region_toy():
    """With od multipliers (1.0, 2.0) the crossover toy keeps its path and
    allocations; only the termination leg, billed at the final region's
    rate, doubles. A scalar 1.0 multiplier changes no bit, and the oracle
    (market.p_od) lands on the same books."""
    job = JobConfig(workload=200.0, deadline=8, n_min=1, n_max=4, value=120.0)
    tput = ThroughputConfig(alpha=1.0, beta=0.0, mu1=0.9, mu2=0.95)
    mkt = _two_region([0.2] * 4 + [0.9] * 4, [0.8] * 4 + [0.3] * 4,
                      np.full(8, 4), p_od=np.array([1.0, 2.0]))
    spec = PolicySpec(KIND_MSU, rsel=RSEL_PRICE, rmargin=0.0)
    out = _toy(mkt, [spec], job, tput, p_od=mkt.p_od)
    np.testing.assert_array_equal(out["region"][0, 0], [0] * 4 + [1] * 4)
    assert not out["n_od"][0, 0].any()
    z_exp = 15.6 + 0.0 + 11.6
    run_cost = 4 * 4 * 0.2 + 3 * 4 * 0.3
    term = 2.0 * job.on_demand_price * job.n_max * (job.workload - z_exp) / 4.0
    assert abs(float(out["cost"][0, 0]) - (run_cost + term)) < 1e-3
    base = _toy(mkt, [spec], job, tput)
    assert abs(float(out["cost"][0, 0]) - float(base["cost"][0, 0])
               - term / 2.0) < 1e-3
    ones = _toy(mkt, [spec], job, tput, p_od=1.0)
    for k in base:
        np.testing.assert_array_equal(base[k], ones[k], err_msg=k)
    ref = simulate_regional(spec.build(), spec.build_selector(), job, tput,
                            mkt, None)
    assert ref.migrations == 1
    np.testing.assert_array_equal(ref.region_hist, [0] * 4 + [1] * 4)
    assert abs(ref.cost - float(out["cost"][0, 0])) < 1e-3


def test_hysteresis_prevents_thrash():
    """A price lead that flips every slot: the margin-0 lane chases it, the
    sticky lane never moves, and with a migration cost it wins."""
    d = 10
    t = np.arange(d)
    mkt = _two_region(0.50 + 0.05 * (t % 2), 0.55 - 0.05 * (t % 2),
                      np.full(d, 8), delta_mig=2)
    specs = [PolicySpec(KIND_MSU, rsel=RSEL_PRICE, rmargin=0.0),
             PolicySpec(KIND_MSU, rsel=RSEL_PRICE, rmargin=0.10)]
    job = JobConfig(workload=200.0, deadline=d, n_min=1, n_max=8, value=120.0)
    out = _toy(mkt, specs, job)
    migs = out["migrations"][0]
    assert migs[0] >= 3 and migs[1] == 0, migs
    assert out["utility"][0, 1] > out["utility"][0, 0]


def test_free_migration_when_delta_zero():
    """delta_mig = 0: the job switches but loses no slot."""
    d = 8
    mkt = _two_region([0.2] * 4 + [0.9] * 4, [0.8] * 4 + [0.3] * 4,
                      np.full(d, 4), delta_mig=0)
    job = JobConfig(workload=200.0, deadline=d, n_min=1, n_max=4, value=120.0)
    out = _toy(mkt, [PolicySpec(KIND_MSU, rsel=RSEL_PRICE)], job)
    np.testing.assert_array_equal(out["n_spot"][0, 0], [4] * d)
    assert int(out["migrations"][0, 0]) == 1
    run_cost = 4 * 4 * 0.2 + 4 * 4 * 0.3
    z_exp = 0.9 * 4 + 7 * 4
    term = job.on_demand_price * 4 * (200.0 - z_exp) / 4.0
    assert abs(float(out["cost"][0, 0]) - (run_cost + term)) < 1e-3


def test_no_migration_after_completion():
    """A job done before the price lead flips is never moved."""
    d = 10
    mkt = _two_region([0.2] * 5 + [0.9] * 5, [0.8] * 5 + [0.3] * 5,
                      np.full(d, 8))
    job = JobConfig(workload=10.0, deadline=d, n_min=1, n_max=8, value=120.0)
    spec = PolicySpec(KIND_MSU, rsel=RSEL_PRICE)
    out = _toy(mkt, [spec], job)
    assert out["completed"][0, 0] and out["migrations"][0, 0] == 0
    assert not out["region"][0, 0].any()
    ref = simulate_regional(spec.build(), spec.build_selector(), job, TPUT,
                            mkt, None)
    assert ref.migrations == 0


def test_no_migration_after_deadline_heterogeneous_batch():
    """In a stacked batch a job past its own deadline is not moved (nor
    charged) by later score flips; a job still running is."""
    dmax = 10
    mkt = _two_region([0.2] * 6 + [0.9] * 4, [0.8] * 6 + [0.3] * 4,
                      np.full(dmax, 2))
    jobs = [JobConfig(workload=500.0, deadline=5, n_min=1, n_max=2,
                      value=120.0),
            JobConfig(workload=500.0, deadline=dmax, n_min=1, n_max=2,
                      value=120.0)]
    spec = PolicySpec(KIND_MSU, rsel=RSEL_PRICE)
    out = _toy(mkt, [spec], None, jobs=jobs)
    migs = out["migrations"][:, 0]
    assert migs[0] == 0 and migs[1] == 1, migs
    assert not out["region"][0, 0].any()
    for ji, job in enumerate(jobs):
        ref = simulate_regional(spec.build(), spec.build_selector(), job,
                                TPUT, mkt, None)
        assert ref.migrations == int(migs[ji]), ji


def test_short_horizon_pred_scores_match_oracle():
    """pred_horizon with a forecast shorter than the scoring window: both
    the prep and the oracle's selector edge-pad it the same way."""
    d, h = 8, 2
    mkt = _two_region([0.3, 0.3] + [0.9] * (d - 2), np.full(d, 0.5),
                      np.full(d, 8))
    pred = RegionalPredictor(mkt).matrix(h)
    spec = PolicySpec(KIND_MSU, rsel=RSEL_PRED)
    job = JobConfig(workload=500.0, deadline=d, n_min=1, n_max=8, value=120.0)
    out = _toy(mkt, [spec], job, pred=pred)
    ref = simulate_regional(spec.build(), spec.build_selector(), job, TPUT,
                            mkt, pred)
    np.testing.assert_array_equal(out["region"][0, 0], ref.region_hist)
    assert int(out["migrations"][0, 0]) == ref.migrations
    assert abs(float(out["utility"][0, 0]) - ref.utility) < 1e-2


def test_greedy_avail_and_pred_horizon_lanes():
    """greedy_avail tracks the deeper pool; pred_horizon sees through a
    one-slot teaser rate that greedy_price grabs (and pays to leave)."""
    d = 6
    mkt = _two_region(np.full(d, 0.5), np.full(d, 0.5), [8, 8, 8, 1, 1, 1],
                      [1, 1, 1, 8, 8, 8], delta_mig=0)
    job = JobConfig(workload=500.0, deadline=d, n_min=1, n_max=8, value=120.0)
    out = _toy(mkt, [PolicySpec(KIND_MSU, rsel=RSEL_AVAIL)], job)
    np.testing.assert_array_equal(out["region"][0, 0], [0, 0, 0, 1, 1, 1])
    mkt = _two_region([0.3] + [1.0] * (d - 1), np.full(d, 0.5),
                      np.full(d, 8))
    pred = RegionalPredictor(mkt).matrix(fast_sim.W1MAX - 1)
    out = _toy(mkt, [PolicySpec(KIND_MSU, rsel=RSEL_PRICE),
                     PolicySpec(KIND_MSU, rsel=RSEL_PRED)], job, pred=pred)
    assert out["region"][0, 0, 0] == 0 and (out["region"][0, 1] == 1).all()
    migs = out["migrations"][0]
    assert migs[1] == 0 and migs[0] >= 1
    assert out["utility"][0, 1] > out["utility"][0, 0]
