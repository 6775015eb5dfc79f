"""The port's fleet engine (``repro_torch.core.fleet``) against the JAX
package's on the CPU: the same numpy inputs (``tests/test_fleet.py``'s
``_contended_fleet``: 12 jobs, 24 slots, a 10-lane pool) through
``jax.jit`` of ``repro.core.fleet.simulate_fleet`` and through the port,
plain, with ``collect=True`` and with the prediction-failure monitor
armed on storm-faulted inputs; then the port's own pins, as the
reference's test file has them: a single job bit-equal to the pool
simulator, the port's ``MultiJobScheduler`` oracle, conservation of
supply, the least-slack-first order, arrival masks and EG admission.

Tolerances. Allocations (``n_od`` / ``n_spot``), ``completed``, the
waterfall's ``tel_grant`` / ``tel_rank`` / ``tel_demand`` and every other
integer or bool series are exact, and so is the monitor's EWMA
``tel_pred_err`` (both blends rounded once, as XLA's fused multiply-add
does; ROADMAP Queue 3, entry 8). ``cost`` / ``utility`` and the other f32
leaves hold to rtol 1e-5, atol 1e-4 (Queue 3, entry 3: the slot bill's
FMA). Against the oracle the utilities, costs and completion times hold to
1e-2, the reference's python-against-device tolerance."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmarks.common import PAPER_JOB
from repro.chaos import FallbackConfig as JFallbackConfig
from repro.chaos import inject, storm_schedule
from repro.core import engine as jengine
from repro.core import fast_sim as jfs
from repro.core import fleet as jfleet
from repro.core import selector as jselector
from repro_torch.chaos import FallbackConfig
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core import engine, fast_sim, fleet, selector
from repro_torch.core.market import vast_like_trace
from repro_torch.core.multi_job import MultiJobScheduler
from repro_torch.core.policy_pool import (KIND_MSU, baseline_specs,
                                          paper_pool, rand_deadline_pool)
from test_fleet import TPUT as JTPUT
from test_fleet import _contended_fleet, _market, _rows, _small_pool

torch.set_num_threads(2)

TPUT = ThroughputConfig(**dataclasses.asdict(JTPUT))
RTOL, ATOL = 1e-5, 1e-4
ORACLE_ATOL = 1e-2
D = 10


def _port_jobs(jobs):
    return fast_sim.stack_jobs([JobConfig(**dataclasses.asdict(j))
                                for j in jobs])


def _assert_matches(got: dict, want: dict):
    """Port result (tensors) against the reference's: integer and bool
    leaves and the monitor's EWMA exact, other floats to RTOL / ATOL."""
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind in "biu" or k == "tel_pred_err":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@functools.lru_cache(maxsize=None)
def _fleet():
    """_contended_fleet's inputs and its JAX result (computed once)."""
    return _contended_fleet()


def _storm(prices, avail, pred):
    """tests/test_fleet.py's storm-faulted market: two 5-slot storms with
    stale forecasts, which arm the monitor."""
    return inject(prices, avail, pred,
                  storm_schedule(1, len(prices), n_storms=2, storm_len=5,
                                 pred_fault="stale"))


@pytest.mark.parametrize("mode", ["plain", "collect", "fallback"])
def test_fleet_matches_reference(mode):
    (_, _, jobs, arrivals, _, prices, avail, pred, rows, want) = _fleet()
    kw, jkw = {}, {}
    if mode == "collect":
        kw = jkw = {"collect": True}
    elif mode == "fallback":
        prices, avail, pred = _storm(prices, avail, pred)
        kw = {"collect": True, "fallback": FallbackConfig(0.5, lam=0.5)}
        jkw = {"collect": True, "fallback": JFallbackConfig(0.5, lam=0.5)}
    if mode != "plain":
        want = jfleet.simulate_fleet(rows, jfs.stack_jobs(jobs), arrivals,
                                     JTPUT, prices, avail, pred, **jkw)
    got = fleet.simulate_fleet(rows, _port_jobs(jobs), arrivals, TPUT,
                               prices, avail, pred, device="cpu", **kw)
    _assert_matches(got, want)
    if mode == "fallback":
        assert got["tel_fallback"].any(), "monitor never armed"
    if mode != "plain":
        assert got["tel_rank"].max() > 0 and got["tel_starved"].any()


def test_single_job_bitwise_matches_pool_sim():
    """No contention: one job through the fleet equals the pool simulator
    bit for bit, for every lane."""
    from repro.core.policy_pool import specs_to_arrays

    pool = _small_pool()
    arrs = specs_to_arrays(pool)
    job = JobConfig(workload=40, deadline=D, n_min=1, n_max=10, value=80.0)
    _, prices, avail, pred = _market(D, seed=1, noise_seed=0)
    stacked = fast_sim.stack_jobs([job])
    base = fast_sim.simulate_pool_jobs(arrs, stacked, TPUT, prices[None],
                                       avail[None], pred[None], device="cpu")
    for li in range(len(pool)):
        out = fleet.simulate_fleet(_rows(arrs, [li]), stacked, [0], TPUT,
                                   prices, avail, pred, device="cpu")
        for k in ("utility", "cost", "completion_time", "z_ddl", "completed",
                  "n_od", "n_spot"):
            np.testing.assert_array_equal(
                base[k][0, li].numpy(), out[k][0].numpy(),
                err_msg=f"{k} lane={pool[li].name}")


def test_fleet_matches_port_oracle():
    """The port's MultiJobScheduler (python policies on the CPU) against
    the port's engine on the contended fleet."""
    (_, idx, jobs, arrivals, _, prices, avail, pred, rows, _) = _fleet()
    pool = (paper_pool(omegas=(2,), sigmas=(0.5,))
            + rand_deadline_pool((0.4,)) + baseline_specs())
    out = fleet.simulate_fleet(rows, _port_jobs(jobs), arrivals, TPUT,
                               prices, avail, pred, device="cpu")
    tr = vast_like_trace(seed=5, days=2).window(0, len(prices) + 1)
    np.testing.assert_array_equal(
        tr.prices[:len(prices)].astype(np.float32), prices)
    sched = MultiJobScheduler(TPUT, tr)
    for i, j in enumerate(jobs):
        sched.submit(int(arrivals[i]), JobConfig(**dataclasses.asdict(j)),
                     pool[int(idx[i])].build(device="cpu"), pred=pred)
    res = {r.job_id: r for r in sched.run(len(prices))}
    for i in range(len(jobs)):
        for field in ("utility", "cost", "completion_time"):
            np.testing.assert_allclose(
                float(out[field][i]), getattr(res[i], field),
                atol=ORACLE_ATOL, err_msg=f"job {i} {field}")


def test_spot_grants_conserve_supply():
    (_, _, jobs, arrivals, _, prices, avail, pred, rows, _) = _fleet()
    out = fleet.simulate_fleet(rows, _port_jobs(jobs), arrivals, TPUT,
                               prices, avail, pred, device="cpu",
                               collect=True)
    granted = out["n_spot"].numpy().sum(axis=0)
    assert np.all(granted <= avail), (granted, avail)
    np.testing.assert_array_equal(out["tel_grant"].numpy().sum(axis=0),
                                  granted)


def test_padded_jobs_are_inert():
    """A job arriving at T (never live) changes no other job's result."""
    (_, _, jobs, arrivals, _, prices, avail, pred, rows, _) = _fleet()
    out = fleet.simulate_fleet(rows, _port_jobs(jobs), arrivals, TPUT,
                               prices, avail, pred, device="cpu")
    rows_p = {k: np.concatenate([v, v[:1]]) for k, v in rows.items()}
    out_p = fleet.simulate_fleet(
        rows_p, _port_jobs(jobs + [jobs[0]]),
        np.concatenate([arrivals, [len(prices)]]), TPUT, prices, avail, pred,
        device="cpu")
    for k in out:
        np.testing.assert_array_equal(out[k].numpy(),
                                      out_p[k][:len(jobs)].numpy(),
                                      err_msg=k)


def test_least_slack_first_and_completion_release():
    """tests/test_fleet.py's hand-checkable case: two all-spot (MSU) jobs on
    a constant 8-unit pool; the tight job drains first (6 of 8), the slack
    one rides the residual (2) until it completes in slot 2, after which
    nothing is granted outside either job's live window."""
    T = 8
    prices = np.full(T, 0.5, np.float32)
    avail = np.full(T, 8, np.int64)
    tight = JobConfig(workload=60, deadline=5, n_min=1, n_max=6, value=80.0)
    slackj = JobConfig(workload=4, deadline=10, n_min=1, n_max=6, value=80.0)
    out = fleet.simulate_fleet({"kind": np.array([KIND_MSU, KIND_MSU])},
                               fast_sim.stack_jobs([tight, slackj]), [0, 0],
                               TPUT, prices, avail, None, device="cpu")
    ns = out["n_spot"].numpy()
    np.testing.assert_array_equal(ns[0], [6, 6, 6, 6, 6, 0, 0, 0])
    np.testing.assert_array_equal(ns[1], [2, 2, 2, 0, 0, 0, 0, 0])
    assert bool(out["completed"][1]) and not bool(out["completed"][0])
    np.testing.assert_allclose(float(out["completion_time"][1]), 2.1,
                               atol=1e-6)


def test_arrival_masks_allocations():
    """A job arriving at a never holds capacity outside [a, a + d)."""
    (_, _, jobs, arrivals, _, prices, avail, pred, rows, _) = _fleet()
    out = fleet.simulate_fleet(rows, _port_jobs(jobs), arrivals, TPUT,
                               prices, avail, pred, device="cpu")
    ts = np.arange(len(prices))[None, :]
    a = np.asarray(arrivals)[:, None]
    d = np.asarray([j.deadline for j in jobs])[:, None]
    outside = (ts < a) | (ts >= a + d)
    assert not out["n_spot"].numpy()[outside].any()
    assert not out["n_od"].numpy()[outside].any()


def test_shared_jobconfig_ties_broken_by_id():
    """benchmarks/fleet_sim.py's shape cut small: every job has the paper's
    JobConfig and arrivals repeat, so equal slack keys are common and the
    job id decides real grants. Grants, ranks and slack keys equal the
    reference's exactly; some slot grants between jobs of equal slack."""
    from repro.core.policy_pool import specs_to_arrays

    arrs = specs_to_arrays(_small_pool())
    rng = np.random.default_rng(3)
    n, t_end = 40, 15
    tr, prices, avail, pred = _market(t_end, seed=8, noise_seed=2)
    arrivals = rng.integers(0, 5, size=n)
    rows = _rows(arrs, rng.integers(0, len(arrs["kind"]), size=n))
    want = jfleet.simulate_fleet(rows, jfs.stack_jobs([PAPER_JOB] * n),
                                 arrivals, JTPUT, prices, avail, pred,
                                 collect=True)
    got = fleet.simulate_fleet(
        rows, _port_jobs([PAPER_JOB] * n), arrivals, TPUT, prices, avail,
        pred, device="cpu", collect=True)
    _assert_matches(got, want)
    slack, dem = got["tel_slack"].numpy(), got["tel_demand"].numpy()
    tied = [len(np.unique(slack[dem[:, t] > 0, t])) < (dem[:, t] > 0).sum()
            for t in range(t_end)]
    assert any(tied), "no slot had demanders of equal slack"


def test_slack_key_is_never_negative_zero():
    """The fleet refuses to sort a -0.0 slack key (a stable sort keeps it
    apart from +0.0). The key is an integer minus a non-negative
    quotient, so the contended fleet never makes one."""
    (_, _, jobs, arrivals, _, prices, avail, pred, rows, _) = _fleet()
    out = fleet.simulate_fleet(rows, _port_jobs(jobs), arrivals, TPUT,
                               prices, avail, pred, device="cpu",
                               collect=True)
    s = out["tel_slack"]
    assert not ((s == 0) & torch.signbit(s)).any()


def test_waterfall_and_rank_match_lexsort():
    """The stable-sort lexsort against numpy's on keys with many ties, and
    the waterfall against the oracle's sequential residual loop."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 60))
        slack = rng.integers(-3, 3, n).astype(np.float32) / 2
        ids = rng.permutation(n).astype(np.int32)
        demand = rng.integers(0, 4, n).astype(np.int32)
        supply = int(rng.integers(0, 3 * n))
        order = fleet._lexsort((torch.from_numpy(ids),
                                torch.from_numpy(slack)))
        np.testing.assert_array_equal(order.numpy(),
                                      np.lexsort((ids, slack)))
        grant = fleet._waterfall(torch.from_numpy(demand),
                                 torch.from_numpy(slack),
                                 torch.from_numpy(ids),
                                 torch.tensor([supply], dtype=torch.int32))
        want, residual = np.zeros(n, np.int32), supply
        for i in np.lexsort((ids, slack)):
            want[i] = min(demand[i], residual)
            residual -= want[i]
        np.testing.assert_array_equal(grant.numpy(), want)
        rank = fleet._demand_rank(torch.from_numpy(demand),
                                  torch.from_numpy(slack),
                                  torch.from_numpy(ids)).numpy()
        dem = np.lexsort((ids, slack, (demand <= 0).astype(np.int32)))
        want_rank = np.full(n, -1)
        want_rank[dem[:int((demand > 0).sum())]] = np.arange(
            int((demand > 0).sum()))
        np.testing.assert_array_equal(rank, want_rank)


# ---------------------------------------------------------------------------
# EG-weighted admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("greedy", [False, True])
def test_policy_rows_from_weights_matches_reference(greedy):
    from repro.core.policy_pool import specs_to_arrays

    arrs = specs_to_arrays(_small_pool())
    w = np.random.default_rng(5).random(len(arrs["kind"])).astype(np.float32)
    w[2] = 0.0
    rows, idx = fleet.policy_rows_from_weights(
        arrs, torch.from_numpy(w), 300, rng=np.random.default_rng(9),
        greedy=greedy)
    jrows, jidx = jfleet.policy_rows_from_weights(
        arrs, w, 300, rng=np.random.default_rng(9), greedy=greedy)
    np.testing.assert_array_equal(idx, jidx)
    assert idx.dtype == np.int32 and set(rows) == set(jrows)
    for k in rows:
        np.testing.assert_array_equal(rows[k], jrows[k], err_msg=k)
    # rng=None draws from a fixed seed
    np.testing.assert_array_equal(
        fleet.policy_rows_from_weights(arrs, w, 16)[1],
        jfleet.policy_rows_from_weights(arrs, w, 16)[1])


def test_sample_policies_matches_reference():
    w = np.random.default_rng(1).random(37).astype(np.float32)
    st = selector.eg_init(37, 8, device="cpu")._replace(
        weights=torch.from_numpy(w))
    for source in (w, torch.from_numpy(w), st):
        np.testing.assert_array_equal(
            selector.sample_policies(source, 500, np.random.default_rng(4)),
            jselector.sample_policies(w, 500, np.random.default_rng(4)))


@pytest.mark.parametrize("greedy", [False, True])
def test_admission_rows_matches_reference(greedy):
    """SelectionResult.admission_rows, the select -> admit loop: the same
    EG weights and generator admit the same policies in both packages."""
    import jax.numpy as jnp
    from repro.core.policy_pool import specs_to_arrays

    arrs = specs_to_arrays(_small_pool())
    m = len(arrs["kind"])
    w = np.random.default_rng(2).random(m).astype(np.float32)
    w /= w.sum()
    st = selector.eg_init(m, 16, device="cpu")._replace(
        weights=torch.from_numpy(w))
    res = engine.SelectionResult(state=st, mean_utility=np.zeros(m),
                                 max_weight=np.zeros(1), regret=np.zeros(1),
                                 n_jobs=0)
    jres = jengine.SelectionResult(
        state=jselector.eg_init(m, 16)._replace(weights=jnp.asarray(w)),
        mean_utility=np.zeros(m), max_weight=np.zeros(1),
        regret=np.zeros(1), n_jobs=0)
    rows, idx = res.admission_rows(arrs, 64, rng=np.random.default_rng(3),
                                   greedy=greedy)
    jrows, jidx = jres.admission_rows(arrs, 64,
                                      rng=np.random.default_rng(3),
                                      greedy=greedy)
    np.testing.assert_array_equal(idx, jidx)
    for k in jrows:
        np.testing.assert_array_equal(rows[k], jrows[k], err_msg=k)
