"""The port's host reference chain against the JAX package's: the python
policies through the reference simulator, the python AHAP's window solve
(``window_opt.solve_window_numpy``, the plain DP on the CPU), the offline
optimum, the ARIMA forecaster, and the port's vectorized pool simulator
against its own python oracle.

Same seeded numpy inputs into both packages. Integers (allocations, plans)
are exact; the window objective is held to ROADMAP Queue 3, entry 2 (rtol
1e-6, atol 1e-4) and the simulator's f32 utilities to entry 3 (rtol 1e-5,
atol 1e-4); the host-numpy pieces (simulate's f64 books, the offline DP,
ARIMA) are bit-equal."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import JobConfig as RefJob
from repro.configs.base import ThroughputConfig as RefTput
from repro.core import offline_opt as ref_off
from repro.core import policy_pool as ref_pool
from repro.core import predictor as ref_pred
from repro.core import simulator as ref_sim
from repro.core import window_opt as ref_wo
from repro.core.market import vast_like_trace as ref_trace
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core import fast_sim, offline_opt, policy_pool, predictor
from repro_torch.core import simulator, window_opt
from repro_torch.core.market import vast_like_trace

torch.set_num_threads(2)

REF_JOB = RefJob(workload=80, deadline=10, n_min=1, n_max=12, value=120.0)
REF_TPUT = RefTput(mu1=0.9, mu2=0.95)
JOB = JobConfig(**dataclasses.asdict(REF_JOB))
TPUT = ThroughputConfig(**dataclasses.asdict(REF_TPUT))
# ROADMAP Queue 3, entries 2 and 3
OBJ_RTOL, OBJ_ATOL = 1e-6, 1e-4
U_RTOL, U_ATOL = 1e-5, 1e-4

SIM_FIELDS = ("utility", "value", "cost", "completion_time", "z_ddl",
              "completed_by_deadline")


def _pool():
    """Every python policy kind: AHAP (plain and Robust), AHANP,
    RAND_DEADLINE (both quantile families), OD-Only, MSU, UP."""
    return (ref_pool.paper_pool(omegas=(1, 3, 5), sigmas=(0.3, 0.7))
            + ref_pool.robust_pool(rhos=(0.5,), omegas=(3,), sigmas=(0.5,))
            + ref_pool.rand_deadline_pool((0.2, 0.6))
            + ref_pool.uniform_rand_deadline_pool((0.35,))
            + ref_pool.baseline_specs())


def _port_spec(spec):
    """A reference PolicySpec as the port's (same fields)."""
    return policy_pool.PolicySpec(**dataclasses.asdict(spec))


def _window(seed, level=0.2, kind="fixed_uniform"):
    """(reference trace window, port trace window, forecast matrix)."""
    tr = ref_trace(seed=seed, days=1).window(0, 11)
    ptr = vast_like_trace(seed=seed, days=1).window(0, 11)
    pred = ref_pred.NoisyPredictor(tr, kind, level, seed=seed).matrix(
        fast_sim.W1MAX - 1)
    return tr, ptr, pred


def _assert_sim_equal(got, want, name):
    for f in ("n_spot", "n_od", "n_total"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{name} {f}")
    for f in SIM_FIELDS:
        assert getattr(got, f) == getattr(want, f), (name, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_python_policies_match_reference(seed):
    """Each python policy's decisions through the reference simulator:
    allocations and the f64 books equal the JAX package's."""
    tr, ptr, pred = _window(seed)
    for spec in _pool():
        pm = pred if spec.kind == ref_pool.KIND_AHAP else None
        want = ref_sim.simulate(spec.build(), REF_JOB, REF_TPUT, tr, pm)
        got = simulator.simulate(_port_spec(spec).build(device="cpu"), JOB,
                                 TPUT, ptr, pm)
        _assert_sim_equal(got, want, spec.name)


def test_msu_weak_and_short_forecast_ahap_match_reference():
    """The paper's literal MSU, and AHAP fed a forecast shorter than its
    window (the plan covers the slots it has)."""
    tr, ptr, _ = _window(4, level=0.3)
    from repro.core import policies as ref_pol
    from repro_torch.core import policies
    want = ref_sim.simulate(ref_pol.MSUWeak(), REF_JOB, REF_TPUT, tr)
    got = simulator.simulate(policies.MSUWeak(), JOB, TPUT, ptr)
    _assert_sim_equal(got, want, "msu_weak")
    pred = ref_pred.NoisyPredictor(tr, "magdep_heavytail", 0.3,
                                   seed=4).matrix(2)
    want = ref_sim.simulate(ref_pol.AHAP(ref_pol.AHAPParams(3, 2, 0.8)),
                            REF_JOB, REF_TPUT, tr, pred)
    got = simulator.simulate(
        policies.AHAP(policies.AHAPParams(3, 2, 0.8), device="cpu"), JOB,
        TPUT, ptr, pred)
    _assert_sim_equal(got, want, "ahap(h=2)")


def _random_window(seed):
    rng = np.random.default_rng(seed)
    w1 = int(rng.integers(1, 7))
    job = dict(workload=float(rng.uniform(20, 150)),
               deadline=int(rng.integers(3, 15)),
               n_min=int(rng.integers(1, 4)), n_max=int(rng.integers(4, 13)),
               value=float(rng.uniform(40, 150)), gamma=2.0,
               on_demand_price=1.0)
    z0 = float(rng.uniform(0, job["workload"]))
    std = int(rng.integers(0, w1 + 2))
    prices = rng.uniform(0.1, 1.4, w1)
    avail = rng.integers(0, 14, w1)
    return job, z0, std, prices, avail


@pytest.mark.parametrize("seed", range(8))
def test_solve_window_numpy_matches_reference(seed):
    """The python policies' window solve against the reference's jitted
    one: the plan exactly, the objective to Queue 3, entry 2."""
    job, z0, std, prices, avail = _random_window(seed)
    want = ref_wo.solve_window_numpy(RefJob(**job), REF_TPUT, z0, std,
                                     prices, avail, 1.0)
    got = window_opt.solve_window_numpy(JobConfig(**job), TPUT, z0, std,
                                        prices, avail, 1.0, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[0].dtype == got[1].dtype == np.int32
    np.testing.assert_allclose(got[2], want[2], rtol=OBJ_RTOL, atol=OBJ_ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_solve_window_numpy_matches_brute_force(seed):
    """The solve is exact: its objective equals the enumerated optimum."""
    job, z0, std, prices, avail = _random_window(100 + seed)
    job.update(n_max=min(job["n_max"], 5))
    prices, avail = prices[:3], avail[:3]
    n_o, n_s, obj = window_opt.solve_window_numpy(
        JobConfig(**job), TPUT, z0, std, prices, avail, 1.0, device="cpu")
    best, plan = window_opt.brute_force_window(JobConfig(**job), TPUT, z0,
                                               std, prices, avail, 1.0)
    assert abs(obj - best) < 1e-3 * max(1.0, abs(best)), (obj, best)


@pytest.mark.parametrize("seed", [0, 3])
def test_solve_offline_exact_and_dominates(seed):
    """The hindsight DP is float64 numpy in both packages: every output
    equal; and no policy beats it on its own trace."""
    tr, ptr, pred = _window(seed)
    want = ref_off.solve_offline(REF_JOB, REF_TPUT, tr)
    got = offline_opt.solve_offline(JOB, TPUT, ptr)
    for f in ("plan_total", "plan_spot", "plan_od"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.utility, got.cost, got.z_ddl) == (want.utility, want.cost,
                                                  want.z_ddl)
    for spec in _pool():
        pm = pred if spec.kind == ref_pool.KIND_AHAP else None
        r = simulator.simulate(_port_spec(spec).build(device="cpu"), JOB,
                               TPUT, ptr, pm)
        assert r.utility <= got.utility + 1e-3, (spec.name, r.utility,
                                                 got.utility)


def test_arima_matrix_and_forecast_errors_bit_equal():
    tr = ref_trace(seed=5, days=4, mean_price=0.7, price_sigma=0.5)
    ptr = vast_like_trace(seed=5, days=4, mean_price=0.7, price_sigma=0.5)
    cfg = ref_pred.ARIMAConfig(seasonal_lag=48, history=2 * 48)
    pcfg = predictor.ARIMAConfig(**dataclasses.asdict(cfg))
    want = ref_pred.ARIMAPredictor(tr, cfg).matrix(4)
    got = predictor.ARIMAPredictor(ptr, pcfg).matrix(4)
    np.testing.assert_array_equal(got, want)
    assert predictor.forecast_errors(
        ptr, predictor.ARIMAPredictor(ptr, pcfg), 4) == \
        ref_pred.forecast_errors(tr, ref_pred.ARIMAPredictor(tr, cfg), 4)
    noisy = predictor.NoisyPredictor(ptr, "fixed_uniform", 0.2, seed=1)
    assert predictor.mape(noisy.matrix(3), predictor._true_future(ptr, 3)) \
        == ref_pred.mape(noisy.matrix(3), ref_pred._true_future(tr, 3))


@pytest.mark.parametrize("seed,kind,level", [
    (0, "fixed_uniform", 0.2), (1, "magdep_heavytail", 0.3),
    (2, "magdep_uniform", 0.1),
])
def test_fast_sim_matches_port_simulator(seed, kind, level):
    """The port's vectorized pool simulator against its own python oracle
    (the counterpart of the reference's fast-sim parity tests): per-slot
    allocations exact, utilities to Queue 3, entry 3."""
    tr, ptr, pred = _window(seed, level, kind)
    specs = [_port_spec(s) for s in _pool()]
    prices, avail, pm = fast_sim.prepare_inputs(ptr, pred, JOB.deadline)
    out = fast_sim.simulate_pool(policy_pool.specs_to_arrays(specs),
                                 fast_sim.JobArrays.of(JOB), TPUT, prices,
                                 avail, pm, device="cpu")
    for i, spec in enumerate(specs):
        r = simulator.simulate(spec.build(device="cpu"), JOB, TPUT, ptr,
                               pred if spec.kind == 0 else None)
        np.testing.assert_array_equal(out["n_spot"][i].numpy(), r.n_spot,
                                      err_msg=spec.name)
        np.testing.assert_array_equal(out["n_od"][i].numpy(), r.n_od,
                                      err_msg=spec.name)
        np.testing.assert_allclose(float(out["utility"][i]), r.utility,
                                   rtol=U_RTOL, atol=U_ATOL,
                                   err_msg=spec.name)
