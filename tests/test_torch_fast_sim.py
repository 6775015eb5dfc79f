"""The port's pool simulator against the JAX package's compiled
``simulate_pool_jobs`` on the 124-lane pool (paper 112 + 9 RAND_DEADLINE +
3 baselines) plus Robust-AHAP lanes, fed the same numpy inputs.

Allocation histories (n_od / n_spot) and ``completed`` are exact. The float
leaves match to rtol 1e-5, atol 1e-4: XLA contracts the slot bill
``n_s * price + n_o * p_o`` into an FMA and torch rounds each product, so
``cost`` and ``utility`` differ by an ulp per billed slot (observed
<= 1.6e-5)."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.common import PAPER_TPUT as REF_TPUT
from benchmarks.fig9_convergence import _engine_inputs
from repro.core import fast_sim as ref_fs
from repro.core import policy_pool as ref_pool
from repro_torch import convert
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import fast_sim

torch.set_num_threads(2)

TPUT = ThroughputConfig(**dataclasses.asdict(REF_TPUT))
POOL = ref_pool.specs_to_arrays(
    ref_pool.paper_pool() + ref_pool.rand_deadline_pool()
    + ref_pool.baseline_specs() + ref_pool.robust_pool(omegas=(3,),
                                                       sigmas=(0.5,))
)


def _assert_matches(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("kind,level,seed", [
    ("magdep_uniform", 0.1, 3), ("fixed_uniform", 0.1, 4),
    ("magdep_heavytail", 0.3, 5), ("fixed_heavytail", 0.3, 6),
])
def test_pool_jobs_matches_reference(kind, level, seed):
    jobs, prices, avail, preds = _engine_inputs(kind, level, 6, seed)
    want = ref_fs.simulate_pool_jobs(POOL, jobs, REF_TPUT, prices, avail,
                                     preds)
    got = fast_sim.simulate_pool_jobs(
        convert.pool_arrays(POOL, "cpu"), convert.job_arrays(jobs, "cpu"),
        TPUT, prices, avail, preds, device="cpu")
    assert got["n_od"].shape == (6, 127, 10)
    _assert_matches(got, want)
    # naming the kernel backend on CPU tensors runs the same plain DP
    again = fast_sim.simulate_pool_jobs(POOL, jobs, TPUT, prices, avail,
                                        preds, backend="cuda", device="cpu")
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_single_job_pool_matches_reference():
    from repro.core.market import vast_like_trace
    from repro.core.predictor import NoisyPredictor

    tr = vast_like_trace(seed=8, days=1, mean_price=0.7, avail_mean=5.5)
    pm = NoisyPredictor(tr, "fixed_uniform", 0.2, seed=2).matrix(5)
    prices, avail, pred = ref_fs.prepare_inputs(tr, pm, 12)
    j = ref_fs.JobArrays.of(ref_fs.JobConfig(
        workload=70.0, deadline=12, n_min=2, n_max=14, value=120.0))
    want = ref_fs.simulate_pool(POOL, j, REF_TPUT, prices, avail, pred)
    got = fast_sim.simulate_pool(
        POOL, fast_sim.JobArrays(*[np.asarray(f) for f in j]), TPUT,
        np.asarray(prices), np.asarray(avail), np.asarray(pred),
        device="cpu")
    _assert_matches(got, want)


def test_single_kind_pools():
    """Pools with only AHAP or only cheap lanes skip the scatter-merge."""
    jobs, prices, avail, preds = _engine_inputs("fixed_uniform", 0.1, 3, 2)
    for specs in (ref_pool.paper_pool(omegas=(2,)),
                  ref_pool.baseline_specs()):
        pool = ref_pool.specs_to_arrays(specs)
        want = ref_fs.simulate_pool_jobs(pool, jobs, REF_TPUT, prices, avail,
                                         preds)
        got = fast_sim.simulate_pool_jobs(pool, jobs, TPUT, prices, avail,
                                          preds, device="cpu")
        _assert_matches(got, want)
