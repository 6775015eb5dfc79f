"""The port's flight recorder against the JAX package's: the ``tel_*``
series of the pool simulator, the EG loop's ``entropy`` / ``top_policy``,
the engine's ``sim_out``, and the ledgers folded from them, on the same
numpy inputs (``_pool_setup`` of tests/test_telemetry.py: 5 jobs, a 7-lane
pool; and a 4-regime scenario grid on the 124-lane pool).

Tolerances. Allocations, the bool event series and ``top_policy`` are
exact. ``cost`` / ``utility`` and the f32 series to rtol 1e-5, atol 1e-4
(ROADMAP Queue 3, entry 3); ``entropy`` to 1e-5 (the EG sums run in another
order than XLA's, entry 4). Ledger floats to rtol 1e-5, atol 1e-4; the
ledgers' own reconciliation residuals within 1e-3, the bound the
reference's cost-reconciliation property states."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmarks import scenario_grid as ref_grid
from benchmarks.common import PAPER_TPUT as REF_PAPER_TPUT
from repro.configs.base import ThroughputConfig as RefThroughputConfig
from repro.core import engine as ref_engine
from repro.core import fast_sim as ref_fs
from repro.core import selector as ref_sel
from repro.core.policy_pool import (baseline_specs, paper_pool,
                                    rand_deadline_pool, specs_to_arrays)
from repro.obs import grid_ledger as ref_grid_ledger
from repro.obs import pool_ledger as ref_pool_ledger
from repro.obs import render as ref_render
from repro.obs import selection_ledger as ref_selection_ledger
from repro_torch import convert, scenarios
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import engine, fast_sim, selector
from repro_torch.obs import (SLOT_KEYS, frame_from_out, grid_ledger,
                             has_telemetry, pool_ledger, render,
                             selection_ledger)
from test_telemetry import TPUT as REF_TPUT
from test_telemetry import _pool_setup
from test_torch_chaos import _assert_matches, assert_json_close

torch.set_num_threads(2)

TPUT = ThroughputConfig(**dataclasses.asdict(REF_TPUT))
PAPER_TPUT = ThroughputConfig(**dataclasses.asdict(REF_PAPER_TPUT))
RESIDUAL_BOUND = 1e-3


def _setup():
    _, arrs, jobs, prices, avail, preds = _pool_setup()
    jobs = ref_fs.JobArrays(*[np.asarray(f) for f in jobs])
    return arrs, jobs, prices, avail, preds


def _sim(setup, **kw):
    arrs, jobs, prices, avail, preds = setup
    return fast_sim.simulate_pool_jobs(arrs, jobs, TPUT, prices, avail,
                                       preds, device="cpu", **kw)


def test_collect_false_is_the_plain_run_and_collect_only_adds_keys():
    setup = _setup()
    base = _sim(setup)
    off = _sim(setup, collect=False)
    on = _sim(setup, collect=True)
    assert set(off) == set(base)
    assert set(on) - set(base) == set(SLOT_KEYS)
    for k in base:
        assert torch.equal(base[k], off[k]), k
        assert torch.equal(base[k], on[k]), k
    assert has_telemetry(on) and not has_telemetry(base)


def test_pool_telemetry_matches_reference():
    setup = _setup()
    arrs, jobs, prices, avail, preds = setup
    got = _sim(setup, collect=True)
    want = ref_fs.simulate_pool_jobs(arrs, jobs, REF_TPUT, prices, avail,
                                     preds, collect=True)
    _assert_matches(got, want)
    assert got["tel_spot_cost"].shape == (5, 7, 10)
    # the per-slot bill sums back to the reported cost (termination cost
    # aside) and progress ends at z_ddl
    fr = frame_from_out({k: v.numpy() for k, v in got.items()})
    np.testing.assert_allclose(fr.progress[..., -1], got["z_ddl"].numpy(),
                               atol=1e-5)
    rc = pool_ledger(got, jobs, TPUT)["cost_reconciliation"]
    assert rc["max_abs_cost_residual"] < RESIDUAL_BOUND, rc
    assert rc["max_abs_utility_residual"] < RESIDUAL_BOUND, rc


def test_single_job_pool_collect_matches_reference():
    arrs, jobs, prices, avail, preds = _setup()
    j = ref_fs.JobArrays(*[f[2] for f in jobs])
    want = ref_fs.simulate_pool(arrs, j, REF_TPUT, prices[2], avail[2],
                                preds[2], collect=True)
    got = fast_sim.simulate_pool(arrs, j, TPUT, prices[2], avail[2],
                                 preds[2], device="cpu", collect=True)
    _assert_matches(got, want)


@pytest.mark.parametrize("seed", [2, 5])
def test_eg_scan_collect_matches_reference(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (40, 8)).astype(np.float32)
    u[:, 3] = u[:, 5]                   # an exact tie: the first max leads
    st0 = selector.eg_init(8, 40, device="cpu")
    st_a, traj_a = selector.run_eg_scan(st0, torch.from_numpy(u))
    st_b, traj_b = selector.run_eg_scan(st0, torch.from_numpy(u),
                                        collect=True, track_history=True)
    for k in traj_a:
        assert torch.equal(traj_a[k], traj_b[k]), k
    assert torch.equal(st_a.weights, st_b.weights)
    _, ref_traj = ref_sel.run_eg_scan(ref_sel.eg_init(8, 40), u,
                                      collect=True)
    np.testing.assert_allclose(traj_b["entropy"].numpy(),
                               np.asarray(ref_traj["entropy"]), rtol=0,
                               atol=1e-5)
    assert traj_b["top_policy"].dtype == torch.int32
    np.testing.assert_array_equal(traj_b["top_policy"].numpy(),
                                  np.asarray(ref_traj["top_policy"]))
    w = traj_b["weights"].double().numpy()
    np.testing.assert_allclose(
        traj_b["entropy"].numpy(),
        -(w * np.log(np.maximum(w, 1e-300))).sum(axis=1), atol=1e-5)
    np.testing.assert_array_equal(traj_b["top_policy"].numpy(),
                                  traj_b["weights"].numpy().argmax(axis=1))
    empty, traj = selector.run_eg_scan(st_b, torch.zeros((0, 8)),
                                       collect=True)
    assert traj["entropy"].shape == (0,) and \
        traj["top_policy"].dtype == torch.int32


def test_select_from_utilities_matches_reference():
    arrs, jobs, prices, avail, preds = _setup()
    u = _sim((arrs, jobs, prices, avail, preds))["utility"]
    m = u.shape[1]
    st, traj = engine.select_from_utilities(
        convert.job_arrays(jobs, "cpu"), u,
        selector.eg_init(m, 5, device="cpu"), track_history=True,
        collect=True)
    ref_st, ref_traj = ref_engine.select_from_utilities(
        jobs, u.numpy(), ref_sel.eg_init(m, 5), track_history=True,
        collect=True)
    np.testing.assert_allclose(st.weights.numpy(),
                               np.asarray(ref_st.weights), atol=1e-6)
    np.testing.assert_array_equal(traj["top_policy"].numpy(),
                                  np.asarray(ref_traj["top_policy"]))
    np.testing.assert_allclose(traj["entropy"].numpy(),
                               np.asarray(ref_traj["entropy"]), atol=1e-5)
    np.testing.assert_allclose(traj["weights"].numpy(),
                               np.asarray(ref_traj["weights"]), atol=1e-5)


def test_engine_collect_false_bitwise_and_chunked():
    arrs, jobs, prices, avail, preds = _setup()
    run = lambda **kw: engine.simulate_and_select(
        arrs, jobs, TPUT, prices, avail, preds, device="cpu",
        return_utilities=True, **kw)
    base, off, on = run(), run(collect=False), run(collect=True)
    for f in ("mean_utility", "max_weight", "regret", "utilities"):
        np.testing.assert_array_equal(getattr(base, f), getattr(off, f))
        np.testing.assert_array_equal(getattr(base, f), getattr(on, f))
    assert off.sim_out is None and off.entropy is None
    assert off.top_policy is None
    assert on.entropy.shape == (5,) and on.top_policy.shape == (5,)
    chunked = run(collect=True, job_chunk=2)
    np.testing.assert_array_equal(chunked.top_policy, on.top_policy)
    np.testing.assert_array_equal(chunked.entropy, on.entropy)
    assert set(chunked.sim_out) == set(on.sim_out)
    for k, v in on.sim_out.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(chunked.sim_out[k], v, err_msg=k)


def test_ledgers_match_reference_and_render():
    pool = (paper_pool(omegas=(2,), sigmas=(0.5,))
            + rand_deadline_pool((0.4,)) + baseline_specs())
    names = [p.name for p in pool]
    arrs, jobs, prices, avail, preds = _setup()
    got = engine.simulate_and_select(arrs, jobs, PAPER_TPUT, prices, avail,
                                     preds, device="cpu", collect=True,
                                     return_utilities=True)
    want = ref_engine.simulate_and_select(arrs, jobs, REF_PAPER_TPUT,
                                          prices, avail, preds,
                                          sharded=False, collect=True,
                                          return_utilities=True)
    meta = [{"key": "r0", "avail_mean": 5.5, "noise": 0.2}]
    ledgers = (
        (pool_ledger(got.sim_out, jobs, PAPER_TPUT, lane_names=names),
         ref_pool_ledger(want.sim_out, jobs, REF_PAPER_TPUT,
                         lane_names=names)),
        (selection_ledger(got), ref_selection_ledger(want)),
        (grid_ledger(meta, got.utilities[None], got.sim_out, jobs,
                     [PAPER_TPUT], 5, lane_names=names),
         ref_grid_ledger(meta, np.asarray(want.utilities)[None],
                         want.sim_out, jobs, [REF_PAPER_TPUT], 5,
                         lane_names=names)),
    )
    for led, ref_led in ledgers:
        back = json.loads(json.dumps(led))
        assert back == led
        assert_json_close(back, ref_led)
        text, ref_text = render(led), ref_render(ref_led)
        assert text.splitlines()[0] == ref_text.splitlines()[0]
        assert text.count("\n") == ref_text.count("\n")
    # on the same outputs the copied ledgers and report are the reference's
    same = pool_ledger(want.sim_out, jobs, PAPER_TPUT, lane_names=names)
    assert same == ledgers[0][1]
    assert render(same) == ref_render(ledgers[0][1])
    assert selection_ledger(want) == ledgers[1][1]


@pytest.mark.parametrize("seed,mu1,mu2", [(0, 0.9, 0.95), (11, 0.55, 0.8),
                                          (23, 0.7, 1.0)])
def test_cost_reconciliation_within_reference_bound(seed, mu1, mu2):
    """The port's per-slot bill, progress and totals reconcile in the
    ledger's f64 recomposition within the bound the reference states for
    its own, across jobs, markets and reconfiguration penalties."""
    tput = ThroughputConfig(mu1=mu1, mu2=mu2)
    arrs, jobs, prices, avail, preds = _setup()
    rng = np.random.default_rng(seed)
    prices = (prices * rng.uniform(0.5, 1.5, prices.shape)).astype(
        np.float32)
    tel = fast_sim.simulate_pool_jobs(arrs, jobs, tput, prices, avail, preds,
                                      device="cpu", collect=True)
    rc = pool_ledger(tel, jobs, tput)["cost_reconciliation"]
    assert rc["max_abs_cost_residual"] < RESIDUAL_BOUND, rc
    assert rc["max_abs_utility_residual"] < RESIDUAL_BOUND, rc


def _ref_tputs(regimes):
    return [RefThroughputConfig(alpha=REF_PAPER_TPUT.alpha,
                                beta=REF_PAPER_TPUT.beta, mu1=r.mu1,
                                mu2=r.mu2) for r in regimes]


def test_scenario_grid_matches_reference():
    """A 4-regime grid (two mu blocks, so two engine calls) of 4 jobs on the
    124-lane pool: inputs bit-equal, winner map and best fixed lane exact,
    utilities and the grid ledger to tolerance."""
    axes = dict(avail=(3.5, 9.0), sigma=(0.5,), tight=(1.15,),
                mu=((0.9, 0.95), (0.7, 0.85)), noise=(0.3,))
    n_jobs = 4
    specs = paper_pool() + rand_deadline_pool() + baseline_specs()
    arrs = specs_to_arrays(specs)
    regimes = scenarios.grid_regimes(**axes)
    ref_regimes = ref_grid.grid_regimes(**axes)
    assert [r.key for r in regimes] == [r.key for r in ref_regimes]
    inputs = scenarios.grid_inputs(regimes, n_jobs)
    ref_inputs = ref_grid.build_grid_inputs(ref_regimes, n_jobs)
    for x, y in zip(ref_inputs[0], inputs[0]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(ref_inputs[1:4], inputs[1:]):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(x, y)

    util, sim_out = scenarios.evaluate_grid(
        arrs, regimes, *inputs, n_jobs, device="cpu", collect=True)
    ref_util, ref_sim_out = ref_grid.evaluate_grid(
        arrs, ref_regimes, *ref_inputs[:4], n_jobs, collect=True)
    np.testing.assert_allclose(util, ref_util, rtol=1e-5, atol=1e-4)
    winners, fixed = scenarios.grid_winners(util)
    ref = ref_grid.analyze_grid(specs, ref_regimes, ref_util, ref_inputs[0])
    np.testing.assert_array_equal(winners, ref["winner_idx"])
    assert fixed == ref["fixed_best"]

    meta = [{"key": r.key, "noise": r.noise} for r in regimes]
    names = [p.name for p in specs]
    led = grid_ledger(meta, util, sim_out, inputs[0],
                      [r.tput for r in regimes], n_jobs, lane_names=names)
    ref_led = ref_grid_ledger(meta, ref_util, ref_sim_out, ref_inputs[0],
                              _ref_tputs(ref_regimes), n_jobs,
                              lane_names=names)
    assert_json_close(json.loads(json.dumps(led)), ref_led)
    assert led["max_abs_cost_residual"] < RESIDUAL_BOUND
    assert led["max_abs_utility_residual"] < RESIDUAL_BOUND
