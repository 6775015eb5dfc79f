"""The port's host copies (market, forecasts, policy pool, job stream, prep)
are bit-equal to the JAX package's on the same seeds, its job model matches
the reference at f32, and ``repro_torch.convert`` carries state across."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import common as ref_common
from repro.core import engine as ref_engine
from repro.core import fast_sim as ref_fs
from repro.core import job as ref_job
from repro.core import market as ref_market
from repro.core import policy_pool as ref_pool
from repro.core import predictor as ref_pred
from repro.core import selector as ref_sel
from repro_torch import convert, workload
from repro_torch.configs import base as tb
from repro_torch.core import engine, fast_sim, job, market, policy_pool
from repro_torch.core import predictor, selector

torch.set_num_threads(1)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("seed,phase", [(0, 0.0), (3, 7.5), (11, 0.0)])
def test_market_trace_bit_equal(seed, phase):
    kw = dict(days=4, mean_price=0.7, price_sigma=0.5,
              season_phase_slots=phase)
    a = ref_market.vast_like_trace(seed=seed, **kw)
    b = market.vast_like_trace(seed=seed, **kw)
    _eq(a.prices, b.prices)
    _eq(a.avail, b.avail)
    assert a.meta == b.meta
    t0s = np.random.default_rng(seed).integers(0, len(a) - 12, 20)
    for x, y in zip(ref_market.gather_windows(a, t0s, 11),
                    market.gather_windows(b, t0s, 11)):
        _eq(x, y)
    wa, wb = a.window(5, 9), b.window(5, 9)
    _eq(wa.prices, wb.prices)
    assert dataclasses.asdict(ref_market.TraceStats.of(a)) == \
        dataclasses.asdict(market.TraceStats.of(b))


def test_market_rejects_bad_input():
    tr = market.vast_like_trace(seed=1, days=1)
    with pytest.raises(ValueError, match="out of bounds"):
        market.gather_windows(tr, [len(tr) - 3], 5)
    with pytest.raises(ValueError, match="non-finite"):
        market.require_finite("x", np.array([1.0, np.nan]))


@pytest.mark.parametrize("kind", predictor.NOISE_KINDS)
def test_forecast_stacks_bit_equal(kind):
    rng = np.random.default_rng(5)
    tr = market.vast_like_trace(seed=2, days=3)
    t0s = rng.integers(0, len(tr) - 12, 7)
    seeds = 1000 + np.arange(7)
    pw, aw = market.gather_windows(tr, t0s, 11)
    level = 0.3 if kind.endswith("heavytail") else 0.1
    _eq(ref_pred.noisy_matrix_batch(pw, aw, kind, level, seeds, 5),
        predictor.noisy_matrix_batch(pw, aw, kind, level, seeds, 5))
    levels = rng.uniform(0, 0.5, 7)
    _eq(ref_pred.noisy_matrix_batch(pw, aw, kind, levels, seeds, 5),
        predictor.noisy_matrix_batch(pw, aw, kind, levels, seeds, 5))
    _eq(ref_pred.true_future_batch(pw, aw, 5),
        predictor.true_future_batch(pw, aw, 5))
    w = ref_market.Trace(tr.prices[:20], tr.avail[:20])
    wt = market.Trace(tr.prices[:20], tr.avail[:20])
    _eq(ref_pred.NoisyPredictor(w, kind, level, seed=4).matrix(5),
        predictor.NoisyPredictor(wt, kind, level, seed=4).matrix(5))
    _eq(ref_pred.PerfectPredictor(w).matrix(3),
        predictor.PerfectPredictor(wt).matrix(3))
    # the engine's prep path
    a = ref_engine.prepare_noisy_inputs(tr, t0s, 10, kind, level, seeds)
    b = engine.prepare_noisy_inputs(tr, t0s, 10, kind, level, seeds)
    for x, y in zip(a, b):
        _eq(x, y)


def test_policy_pools_bit_equal():
    pools = [
        (ref_pool.paper_pool(), policy_pool.paper_pool()),
        (ref_pool.paper_pool(fixed_v=1, rand_qs=(0.2, 0.7)),
         policy_pool.paper_pool(fixed_v=1, rand_qs=(0.2, 0.7))),
        (ref_pool.rand_deadline_pool(), policy_pool.rand_deadline_pool()),
        (ref_pool.uniform_rand_deadline_pool(),
         policy_pool.rand_deadline_pool(qfn=policy_pool.uniform_commit_frac)),
        (ref_pool.baseline_specs(), policy_pool.baseline_specs()),
        (ref_pool.robust_pool(), policy_pool.robust_pool()),
    ]
    for ref_specs, specs in pools:
        assert [s.name for s in ref_specs] == [s.name for s in specs]
        ra, pa = ref_pool.specs_to_arrays(ref_specs), \
            policy_pool.specs_to_arrays(specs)
        assert set(pa) <= set(ra)
        for k in pa:
            _eq(ra[k], pa[k])
    assert len(policy_pool.paper_pool()) == 112
    with pytest.raises(ValueError, match="commitment fraction"):
        policy_pool.rand_deadline_pool((0.5,), qfn=lambda q: -1.0)


def test_job_stream_and_market_regime_bit_equal():
    a = ref_common.job_stream_arrays(np.random.default_rng(9), 40,
                                     workload_scale=1.15)
    b = workload.job_stream_arrays(np.random.default_rng(9), 40,
                                   workload_scale=1.15)
    for x, y in zip(a, b):
        _eq(x, y)
    ta, tb_ = ref_common.paper_market(seed=21, days=5), \
        workload.paper_market(seed=21, days=5)
    _eq(ta.prices, tb_.prices)
    _eq(ta.avail, tb_.avail)
    assert dataclasses.asdict(ref_common.PAPER_TPUT) == \
        dataclasses.asdict(workload.PAPER_TPUT)
    jobs = list(ref_common.job_stream(np.random.default_rng(2), 5))
    port_jobs = [tb.JobConfig(**dataclasses.asdict(j)) for j in jobs]
    for x, y in zip(ref_fs.stack_jobs(jobs), fast_sim.stack_jobs(port_jobs)):
        _eq(x, y)


def test_prepare_inputs_bit_equal():
    tr = market.vast_like_trace(seed=4, days=1)
    pm = predictor.NoisyPredictor(tr, "fixed_uniform", 0.2, seed=1).matrix(3)
    for m in (None, pm):
        a = ref_fs.prepare_inputs(tr, m, 10)
        b = fast_sim.prepare_inputs(tr, m, 10)
        for x, y in zip(a, b):
            _eq(x, y)


def test_job_model_matches_reference():
    """value_fn / tilde_value / normalization: torch eager vs JAX eager, both
    op by op in f32 (no fused multiply-add on either side) — bit-equal."""
    rng = np.random.default_rng(0)
    ref_tput = ref_common.PAPER_TPUT
    tput = workload.PAPER_TPUT
    for _ in range(5):
        kw = dict(workload=float(rng.uniform(20, 120)),
                  deadline=int(rng.integers(2, 12)),
                  n_min=int(rng.integers(1, 4)),
                  n_max=int(rng.integers(4, 17)),
                  value=float(rng.uniform(10, 200)),
                  gamma=float(rng.uniform(1.2, 3.0)))
        rj, pj = ref_job.JobConfig(**kw), tb.JobConfig(**kw)
        T = rng.uniform(0, 3 * kw["deadline"], 50).astype(np.float32)
        z = rng.uniform(0, kw["workload"] * 1.2, 50).astype(np.float32)
        _eq(ref_job.value_fn(rj, jnp.asarray(T)),
            job.value_fn(pj, torch.from_numpy(T)).numpy())
        _eq(ref_job.tilde_value(rj, ref_tput, jnp.asarray(z)),
            job.tilde_value(pj, tput, torch.from_numpy(z)).numpy())
    jobs = ref_common.job_stream_arrays(np.random.default_rng(1), 30)
    u = np.random.default_rng(2).uniform(-300, 150, (30, 9)).astype(
        np.float32)
    _eq(ref_job.normalize_utility_batch(jobs, jnp.asarray(u)),
        job.normalize_utility_batch(convert.job_arrays(jobs, "cpu"),
                                    torch.from_numpy(u)).numpy())


def test_numpy_selector_loop_matches_reference():
    u = np.random.default_rng(3).uniform(0, 1, (40, 12))
    a = ref_sel.init_selector(12, 40, track_history=True, history_stride=4)
    b = selector.init_selector(12, 40, track_history=True, history_stride=4)
    for row in u:
        ref_sel.update(a, row, track_history=True)
        selector.update(b, row, track_history=True)
    _eq(a.weights, b.weights)
    assert a.cum_expected == b.cum_expected
    assert len(a.weight_history) == len(b.weight_history) == 11
    assert ref_sel.regret(a) == selector.regret(b)
    assert ref_sel.best_policy(a) == selector.best_policy(b)
    assert ref_sel.default_eta(12, 40) == selector.default_eta(12, 40)
    assert ref_sel.regret_bound(12, 40) == selector.regret_bound(12, 40)


def test_convert_round_trips():
    pool = ref_pool.specs_to_arrays(ref_pool.paper_pool()[:9])
    tp = convert.pool_arrays(pool, "cpu")
    assert set(tp) == {"kind", "omega", "v", "sigma", "rho", "cfrac", "rsel",
                       "rmargin"}
    for k, v in tp.items():
        _eq(pool[k], v.numpy())
    jobs = ref_common.job_stream_arrays(np.random.default_rng(4), 6)
    for x, y in zip(jobs, convert.job_arrays(jobs, "cpu")):
        _eq(x, y.numpy())
    st = ref_sel.eg_init(9, 100)
    ts = convert.eg_state(st, "cpu")
    back = ref_sel.EGState(**convert.eg_state_to_numpy(ts))
    for f in ref_sel.EGState._fields:
        _eq(getattr(st, f), getattr(back, f))


@pytest.mark.parametrize("alpha,beta,mu1,mu2", [
    (1.0, 0.0, 0.9, 0.95), (0.7, 0.3, 0.75, 0.85), (1.3, 0.1, 1.0, 0.6)])
def test_throughput_model_bit_equal(alpha, beta, mu1, mu2):
    import importlib

    from repro.configs.base import ThroughputConfig as RefTput
    from repro_torch.core import throughput as tp

    # repro.core re-exports a function under the module's name
    ref_tp = importlib.import_module("repro.core.throughput")

    ref_t = RefTput(alpha=alpha, beta=beta, mu1=mu1, mu2=mu2)
    t = tb.ThroughputConfig(alpha=alpha, beta=beta, mu1=mu1, mu2=mu2)
    rng = np.random.default_rng(int(alpha * 10))
    n_prev = rng.integers(0, 5, 64).astype(np.int32)
    n_now = rng.integers(0, 5, 64).astype(np.int32)
    n_now[:8] = n_prev[:8]                      # unchanged, zeros included
    n_prev[8:12] = n_now[8:12] = 0
    for a, b in (
        (ref_tp.throughput(ref_t, n_now),
         tp.throughput(t, torch.from_numpy(n_now))),
        (ref_tp.mu_factor(ref_t, n_prev, n_now),
         tp.mu_factor(t, torch.from_numpy(n_prev), torch.from_numpy(n_now))),
        (ref_tp.effective_work(ref_t, n_prev, n_now),
         tp.effective_work(t, torch.from_numpy(n_prev),
                           torch.from_numpy(n_now))),
    ):
        _eq(a, b.numpy())
    # python scalars
    assert float(tp.effective_work(t, 2, 3)) == \
        float(ref_tp.effective_work(ref_t, 2, 3))
    assert float(tp.throughput(t, 0)) == 0.0


def test_job_scalars_bit_equal():
    """expected_progress, normalization_bounds and the one-job
    normalize_utility, on python scalars and on f32 / f64 arrays."""
    rng = np.random.default_rng(7)
    for _ in range(4):
        kw = dict(workload=float(rng.uniform(20, 120)),
                  deadline=int(rng.integers(2, 12)),
                  n_min=int(rng.integers(1, 4)),
                  n_max=int(rng.integers(4, 17)),
                  value=float(rng.uniform(10, 200)),
                  gamma=float(rng.uniform(1.2, 3.0)),
                  on_demand_price=float(rng.uniform(0.5, 2.0)))
        rj, pj = ref_job.JobConfig(**kw), tb.JobConfig(**kw)
        assert ref_job.normalization_bounds(rj) == \
            job.normalization_bounds(pj)
        for t in (0, 3, 7.5):
            assert ref_job.expected_progress(rj, t) == \
                job.expected_progress(pj, t)
        ts = np.arange(kw["deadline"], dtype=np.int32)
        _eq(ref_job.expected_progress(rj, jnp.asarray(ts)),
            job.expected_progress(pj, torch.from_numpy(ts)).numpy())
        lo, hi = job.normalization_bounds(pj)
        u = rng.uniform(lo * 1.1, hi * 1.1, 40)
        for arr in (u.astype(np.float32), u):
            want = ref_job.normalize_utility(rj, arr)
            got = job.normalize_utility(pj, arr)
            assert got.dtype == torch.float32
            _eq(want, got.numpy())
        _eq(ref_job.normalize_utility(rj, u.astype(np.float32)),
            job.normalize_utility(
                pj, torch.from_numpy(u.astype(np.float32))).numpy())


def test_job_arrays_of_concat_unstack_bit_equal():
    jobs = list(ref_common.job_stream(np.random.default_rng(6), 5))
    port_jobs = [tb.JobConfig(**dataclasses.asdict(j)) for j in jobs]
    for rj, pj in zip(jobs, port_jobs):
        for x, y in zip(ref_fs.JobArrays.of(rj), fast_sim.JobArrays.of(pj)):
            _eq(x, y)
    parts = [ref_common.job_stream_arrays(np.random.default_rng(s), n,
                                          workload_scale=w)
             for s, n, w in ((1, 3, 0.8), (2, 1, 1.0), (3, 4, 1.15))]
    want = ref_fs.concat_jobs(parts)
    got = fast_sim.concat_jobs(parts)
    for x, y in zip(want, got):
        _eq(x, y)
    assert fast_sim.concat_jobs(parts[:1]) is parts[0]
    for a, b in zip(fast_sim.slice_jobs(got, 3, 4), parts[1]):
        _eq(a, b)
    ref_rows = ref_fs.unstack_jobs(want)
    rows = fast_sim.unstack_jobs(got)
    assert [dataclasses.asdict(r) for r in ref_rows] == \
        [dataclasses.asdict(r) for r in rows]
    # unstack reads tensor leaves too, and stack_jobs inverts it
    rows_t = fast_sim.unstack_jobs(convert.job_arrays(got, "cpu"))
    assert rows_t == rows
    for x, y in zip(fast_sim.stack_jobs(rows), got):
        _eq(x, y)
