"""The port's regional selection engine (``engine.simulate_and_select`` with
``delta_mig=``, ``p_od=`` and ``prep=``) and its regional prep against the
JAX package's, and against itself: chunked against unchunked, ``prep=``
against arrays, R = 1 against the single-region engine, the
torch-drawn forecast stacks against the numpy oracle.

Winners and iters-to-half are exact against JAX; weights to 1e-5 and regret
to 1e-5 per job (ROADMAP Queue 3, entry 4). The port against itself is bit
for bit. The torch-drawn stacks cannot equal numpy's draws: they match the
oracle on the winner and on the regret ratio within 0.05, as the JAX
package's tests hold its JAX-PRNG prep, and exactly at level 0."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.common import PAPER_TPUT as REF_TPUT
from benchmarks.common import job_stream_arrays
from repro.core import engine as ref_engine
from repro.core import policy_pool as ref_pool
from repro.core.region_market import vast_like_regions as ref_regions
from repro_torch.chaos import FallbackConfig
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import engine
from repro_torch.core.policy_pool import (baseline_specs, paper_pool,
                                          rand_deadline_pool, region_pool,
                                          specs_to_arrays)
from repro_torch.core.region_market import vast_like_regions
from repro_torch.obs import ledger

torch.set_num_threads(2)

TPUT = ThroughputConfig(**dataclasses.asdict(REF_TPUT))
DEADLINE = 10
KIND, LEVEL, SEED = "fixed_uniform", 0.2, 7
REGRET_ATOL = 1e-5
POOL = specs_to_arrays(region_pool())


def _workload(n_jobs, n_regions=3, days=2.0):
    """(port market, reference market, jobs, t0s, seeds): the reference
    tests' regional workload, one copy of the market per package."""
    kw = dict(seed=13, days=days, delta_mig=1)
    market = vast_like_regions(n_regions, **kw)
    rng = np.random.default_rng(SEED)
    jobs = job_stream_arrays(rng, n_jobs, DEADLINE)
    t0s = rng.integers(0, len(market) - DEADLINE - 1, size=n_jobs)
    seeds = SEED * 100003 + np.arange(n_jobs)
    return market, ref_regions(n_regions, **kw), jobs, t0s, seeds


def _prep(market, t0s, seeds, level=LEVEL, **kw):
    return engine.prepare_noisy_inputs_regions(market, t0s, DEADLINE, KIND,
                                               level, seeds, **kw)


def _run(market, jobs, t0s, seeds, pool=POOL, **kw):
    return engine.simulate_and_select(pool, jobs, TPUT,
                                      *_prep(market, t0s, seeds),
                                      delta_mig=market.delta_mig,
                                      device="cpu", **kw)


def _assert_same(a, b, bitwise_mean=True):
    assert torch.equal(a.state.weights, b.state.weights)
    np.testing.assert_array_equal(a.max_weight, b.max_weight)
    np.testing.assert_array_equal(a.regret, b.regret)
    if bitwise_mean:
        np.testing.assert_array_equal(a.mean_utility, b.mean_utility)
    else:
        np.testing.assert_allclose(a.mean_utility, b.mean_utility, rtol=1e-6,
                                   atol=1e-5)


def test_prepare_noisy_inputs_regions_bit_equal():
    """The numpy prep row for row and bit for bit the reference's."""
    market, ref_market, _, t0s, seeds = _workload(6)
    want = ref_engine.prepare_noisy_inputs_regions(ref_market, t0s, DEADLINE,
                                                   KIND, LEVEL, seeds)
    got = _prep(market, t0s, seeds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("p_od", [None, (1.0, 1.3, 0.8)])
def test_regional_engine_matches_reference(p_od):
    market, ref_market, jobs, t0s, seeds = _workload(16)
    want = ref_engine.simulate_and_select(
        ref_pool.specs_to_arrays(ref_pool.region_pool()), jobs, REF_TPUT,
        *ref_engine.prepare_noisy_inputs_regions(ref_market, t0s, DEADLINE,
                                                 KIND, LEVEL, seeds),
        sharded=False, delta_mig=1, p_od=p_od, job_chunk=5,
        return_utilities=True)
    got = _run(market, jobs, t0s, seeds, p_od=p_od, job_chunk=5,
               return_utilities=True)
    assert got.best_policy() == want.best_policy()
    assert got.iters_to_half() == want.iters_to_half()
    np.testing.assert_allclose(got.utilities, want.utilities, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.max_weight, want.max_weight, atol=1e-5)
    np.testing.assert_allclose(got.regret, want.regret,
                               atol=REGRET_ATOL * 16)


def test_region_engine_chunked_equals_unchunked():
    """Chunk sizes 1 / dividing / == K / non-dividing / > K: trajectories
    and final weights bit for bit."""
    market, _, jobs, t0s, seeds = _workload(12)
    base = _run(market, jobs, t0s, seeds)
    for chunk in (1, 3, 5, 12, 20):
        _assert_same(base, _run(market, jobs, t0s, seeds, job_chunk=chunk),
                     bitwise_mean=False)


def test_region_engine_prep_callable_matches_arrays():
    """``prep=`` (the double-buffered path) against the sliced arrays: the
    same chunk inputs, so the same result bit for bit, with and without the
    flight recorder."""
    market, _, jobs, t0s, seeds = _workload(12)
    prep = lambda lo, hi: _prep(market, t0s[lo:hi], seeds[lo:hi])
    for kw in (dict(), dict(collect=True, p_od=(1.0, 1.3, 0.8))):
        base = _run(market, jobs, t0s, seeds, job_chunk=5, **kw)
        streamed = engine.simulate_and_select(
            POOL, jobs, TPUT, None, None, None, delta_mig=1, job_chunk=5,
            prep=prep, device="cpu", **kw)
        _assert_same(base, streamed)
        if kw:
            for k in base.sim_out:
                np.testing.assert_array_equal(base.sim_out[k],
                                              streamed.sim_out[k], err_msg=k)
    with pytest.raises(ValueError, match="prep="):
        engine.simulate_and_select(POOL, jobs, TPUT, None, None, None,
                                   delta_mig=1, device="cpu")


def test_r1_engine_bit_equal_to_single_region():
    """One region: the regional engine lands on the single-region engine's
    result bit for bit (region 0 is seeded seeds * 1009)."""
    market, _, jobs, t0s, seeds = _workload(10, n_regions=1)
    pool = specs_to_arrays(paper_pool(omegas=(1, 3), sigmas=(0.3,))
                           + rand_deadline_pool((0.2,)) + baseline_specs())
    p, a, m = engine.prepare_noisy_inputs(market.region(0), t0s, DEADLINE,
                                          KIND, LEVEL, seeds * 1009)
    rp, ra, rpm = _prep(market, t0s, seeds)
    for x, y in ((rp[:, 0], p), (ra[:, 0], a), (rpm[:, 0], m)):
        np.testing.assert_array_equal(x, y)
    single = engine.simulate_and_select(pool, jobs, TPUT, p, a, m,
                                        device="cpu")
    regional = engine.simulate_and_select(pool, jobs, TPUT, rp, ra, rpm,
                                          delta_mig=1, device="cpu")
    _assert_same(single, regional)


def test_torch_prep_zero_level_is_exact_truth():
    """At level 0 the device stacks have nothing to draw: equal to the
    numpy oracle's, single-region and regional."""
    market, _, _, t0s, seeds = _workload(4)
    for kind in ("fixed_uniform", "magdep_heavytail"):
        want = engine.prepare_noisy_inputs_regions(market, t0s, DEADLINE,
                                                   kind, 0.0, seeds)
        got = engine.prepare_noisy_inputs_regions(
            market, t0s, DEADLINE, kind, 0.0, seeds, prep_backend="torch",
            device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)
        want = engine.prepare_noisy_inputs(market.region(1), t0s, DEADLINE,
                                           kind, 0.0, seeds)
        got = engine.prepare_noisy_inputs(market.region(1), t0s, DEADLINE,
                                          kind, 0.0, seeds,
                                          prep_backend="torch", device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)
    with pytest.raises(ValueError, match="prep_backend"):
        _prep(market, t0s, seeds, prep_backend="jax")


def test_torch_prep_winner_and_regret_parity():
    """The torch-drawn stacks against the numpy oracle: the same
    winning lane and a regret ratio within 0.05, both under the Theorem 2
    bound; a row's draws depend on its seed alone, so a chunked prep
    equals the whole one. 48 jobs, four times the reference test's 12: at
    12 the leader's weight (0.039 against a uniform 0.028) is barely a
    decision, so another draw of the same distribution may name another
    lane."""
    market, _, jobs, t0s, seeds = _workload(48)
    res = {}
    for backend in ("numpy", "torch"):
        res[backend] = engine.simulate_and_select(
            POOL, jobs, TPUT,
            *_prep(market, t0s, seeds, prep_backend=backend, device="cpu"),
            delta_mig=1, device="cpu")
    assert res["numpy"].best_policy() == res["torch"].best_policy()
    rr_np, rr_t = res["numpy"].regret_ratio(), res["torch"].regret_ratio()
    assert abs(rr_np - rr_t) < 0.05, (rr_np, rr_t)
    assert rr_np < 1.0 and rr_t < 1.0
    whole = _prep(market, t0s[:12], seeds[:12], prep_backend="torch",
                  device="cpu")[2]
    part = _prep(market, t0s[4:9], seeds[4:9], prep_backend="torch",
                 device="cpu")[2]
    assert torch.equal(whole[4:9], part)


def test_region_engine_collect_reconciles_and_fallback_is_inert():
    """``collect=True``: the chunk-concatenated ``sim_out`` reconciles its
    migration series with its leaves across chunk boundaries; an armed
    monitor that never trips changes no shared output."""
    market, _, jobs, t0s, seeds = _workload(8)
    base = _run(market, jobs, t0s, seeds, job_chunk=3)
    res = _run(market, jobs, t0s, seeds, job_chunk=3, collect=True)
    _assert_same(base, res)
    assert base.sim_out is None and res.entropy is not None
    recon = ledger.migration_reconciliation(res.sim_out)
    assert recon["events_reconciled"] and recon["series_matches_leaf"]
    assert recon["total_migrations"] > 0
    quiet = _run(market, jobs, t0s, seeds, job_chunk=3, collect=True,
                 fallback=FallbackConfig(threshold=1e9))
    _assert_same(res, quiet)
    assert not quiet.sim_out["tel_fallback"].any()
    for k in res.sim_out:
        np.testing.assert_array_equal(res.sim_out[k], quiet.sim_out[k],
                                      err_msg=k)
