"""The port's seed path of the pool simulator (``fast_sim.simulate_one``,
``_simulate_one_ahap``, ``simulate_pool_monolithic`` and its jobs-batched
``simulate_pool_jobs_monolithic``) against the port's partitioned path and
the JAX package's seed path, on the inputs of
``tests/test_selector_fastsim.py``'s equivalence tests.

Within the port the seed path is bit-equal to the partitioned one: every
lane's rules, K1's rows included, are elementwise over the lanes. Against
the JAX package the allocations and every integer or bool leaf are exact
and the f32 leaves hold to ROADMAP Queue 3, entry 3 (the slot bill's FMA:
rtol 1e-5, atol 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import job_stream
from repro.configs.base import JobConfig as JJobConfig
from repro.configs.base import ThroughputConfig as JThroughputConfig
from repro.core import fast_sim as jfs
from repro.core.market import vast_like_trace
from repro.core.policy_pool import (baseline_specs, paper_pool,
                                    rand_deadline_pool, robust_pool,
                                    specs_to_arrays)
from repro.core.predictor import NoisyPredictor
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import fast_sim

torch.set_num_threads(2)

JOB = JJobConfig(workload=80, deadline=10, n_min=1, n_max=12, value=120.0)
JTPUT = JThroughputConfig(mu1=0.9, mu2=0.95)
TPUT = ThroughputConfig(**dataclasses.asdict(JTPUT))
RTOL, ATOL = 1e-5, 1e-4


def _single(seed: int):
    tr = vast_like_trace(seed=seed, days=1).window(0, 10)
    pred = NoisyPredictor(tr, "fixed_uniform", 0.2, seed=seed).matrix(
        jfs.W1MAX - 1)
    prices, avail, pm = jfs.prepare_inputs(tr, pred, JOB.deadline)
    j = jfs.JobArrays.of(JOB)
    return (j, np.asarray(prices), np.asarray(avail), np.asarray(pm),
            fast_sim.JobArrays(*[np.asarray(f) for f in j]))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_monolithic_matches_partitioned_and_reference():
    """The seed path equals the kind-partitioned pool path bit for bit
    (same lanes, same order, same leaves), RAND_DEADLINE lanes included,
    and matches the JAX seed path (tests/test_selector_fastsim.py's
    test_fast_sim_partitioned_matches_monolithic inputs)."""
    pool = (paper_pool(omegas=(2, 4), sigmas=(0.4, 0.8))
            + rand_deadline_pool((0.2, 0.6)) + baseline_specs())
    arrs = specs_to_arrays(pool)
    j, prices, avail, pm, pj = _single(5)
    mono = fast_sim.simulate_pool_monolithic(arrs, pj, TPUT, prices, avail,
                                             pm, device="cpu")
    part = fast_sim.simulate_pool(arrs, pj, TPUT, prices, avail, pm,
                                  device="cpu")
    _equal(mono, part)
    assert mono["n_od"].shape == (len(pool), JOB.deadline)
    _close(mono, jfs.simulate_pool_monolithic(arrs, j, JTPUT, prices, avail,
                                              pm))


def test_jobs_monolithic_matches_partitioned_pool_jobs():
    """Over a batch of jobs (one window solve a slot over every (job,
    lane) row) the seed path equals simulate_pool_jobs bit for bit on the
    124-lane pool plus Robust-AHAP lanes."""
    pool = (paper_pool() + rand_deadline_pool() + baseline_specs()
            + robust_pool(omegas=(3,), sigmas=(0.5,)))
    arrs = specs_to_arrays(pool)
    rng = np.random.default_rng(11)
    jobs = jfs.stack_jobs(list(job_stream(rng, 4, deadline=10)))
    traces = [vast_like_trace(seed=70 + i, days=1).window(0, 11)
              for i in range(4)]
    prices = np.stack([t.prices[:10] for t in traces]).astype(np.float32)
    avail = np.stack([t.avail[:10] for t in traces]).astype(np.int64)
    preds = np.stack([NoisyPredictor(t, "magdep_uniform", 0.3,
                                     seed=i).matrix(5)[:10]
                      for i, t in enumerate(traces)]).astype(np.float32)
    pj = fast_sim.JobArrays(*[np.asarray(f) for f in jobs])
    mono = fast_sim.simulate_pool_jobs_monolithic(arrs, pj, TPUT, prices,
                                                  avail, preds, device="cpu")
    part = fast_sim.simulate_pool_jobs(arrs, pj, TPUT, prices, avail, preds,
                                       device="cpu")
    _equal(mono, part)
    assert mono["n_od"].shape == (4, len(pool), 10)


def test_one_ahap_lanes_match_batched_lanes_and_reference():
    """``_simulate_one_ahap`` (scaffolding for every slot built before the
    loop, one lane a call) over the AHAP lanes equals the lane-batched
    ``_simulate_lanes_ahap`` bit for bit, and matches ``jax.vmap`` of the
    JAX package's ``_simulate_one_ahap``."""
    pool = [s for s in paper_pool(omegas=(1, 3, 5), sigmas=(0.3, 0.7))
            if s.kind == 0] + robust_pool(omegas=(3,), sigmas=(0.5,))
    arrs = specs_to_arrays(pool)
    j, prices, avail, pm, pj = _single(8)
    args = [arrs[k] for k in ("omega", "v", "sigma", "rho")]
    dev = torch.device("cpu")
    lanes = fast_sim._simulate_lanes_ahap(
        *[torch.as_tensor(a) for a in args],
        fast_sim.jobs_to(fast_sim.JobArrays(*[np.asarray(f)[None]
                                              for f in pj]), dev),
        TPUT, torch.tensor(prices)[None],
        torch.tensor(avail, dtype=torch.int32)[None],
        torch.tensor(pm)[None], None, dev)
    ones = [fast_sim._simulate_one_ahap(*[a[i] for a in args], pj, TPUT,
                                        prices, avail, pm, device="cpu")
            for i in range(len(pool))]
    stacked = {k: torch.stack([o[k] for o in ones]) for k in ones[0]}
    _equal(stacked, {k: v[0] for k, v in lanes.items()})
    oracle = jax.vmap(lambda a, b, c, d: jfs._simulate_one_ahap(
        a, b, c, d, j, JTPUT, jnp.asarray(prices), jnp.asarray(avail),
        jnp.asarray(pm), "xla"))(*[jnp.asarray(a) for a in args])
    _close(stacked, oracle)


@pytest.mark.parametrize("lane", [0, 7, 12, 15, 17])
def test_simulate_one_is_a_pool_lane(lane):
    """``simulate_one`` is the seed path at P = 1: each lane's scalars and
    histories equal its row of simulate_pool_monolithic, and the JAX
    package's ``simulate_one`` within Queue 3's tolerance."""
    pool = (paper_pool(omegas=(2, 4), sigmas=(0.4, 0.8))
            + rand_deadline_pool((0.2, 0.6)) + baseline_specs())
    arrs = specs_to_arrays(pool)
    j, prices, avail, pm, pj = _single(6)
    enc = [arrs[k][lane] for k in ("kind", "omega", "v", "sigma")]
    got = fast_sim.simulate_one(*enc, pj, TPUT, prices, avail, pm,
                                rho=arrs["rho"][lane],
                                cfrac=arrs["cfrac"][lane], device="cpu")
    mono = fast_sim.simulate_pool_monolithic(arrs, pj, TPUT, prices, avail,
                                             pm, device="cpu")
    _equal(got, {k: v[lane] for k, v in mono.items()})
    want = jax.jit(lambda: jfs.simulate_one(
        *[jnp.asarray(e) for e in enc], j, JTPUT, jnp.asarray(prices),
        jnp.asarray(avail), jnp.asarray(pm),
        rho=jnp.float32(arrs["rho"][lane]),
        cfrac=jnp.float32(arrs["cfrac"][lane])))()
    _close(got, want)
