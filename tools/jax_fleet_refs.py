"""Record the JAX package's results on chip_smoke.py's ``[fleet]`` phase,
which holds the PyTorch port to them on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_fleet_refs.py

Runs the reference (``repro``) on the CPU at ``benchmarks/fleet_sim.py``'s
full size, its inputs drawn as that bench's ``_workload`` draws them: an EG
pilot of 128 jobs on ``paper_market(seed=31, days=40)`` over the 124-lane
pool (fixed-magnitude uniform 10% noise, seed 13), then 1000 jobs admitted
from the pilot's weights (``SelectionResult.admission_rows``) arriving in
slots [0, 5) of ``paper_market(seed=29, days=3).window(0, 16)`` and run
for 15 slots through the unsharded ``fleet.simulate_fleet``; then the same
fleet with every job admitted on the pilot's leader (``greedy=True``).
Prints the ``JAX_FLEET`` constant as chip_smoke.py holds it, and the
seconds each part took on stderr.
"""
import os
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmarks import fleet_sim  # noqa: E402
from benchmarks.common import (PAPER_JOB, PAPER_TPUT,  # noqa: E402
                               job_stream_arrays, paper_market)
from repro.core import engine, fast_sim, fleet  # noqa: E402
from repro.core.policy_pool import (baseline_specs, paper_pool,  # noqa: E402
                                    rand_deadline_pool, specs_to_arrays)
from repro.core.predictor import NoisyPredictor  # noqa: E402


def workload(arrs):
    """``fleet_sim._workload``'s draws, in its order, with the unsharded
    engine: (prices, avail, pred, arrivals, pilot result, rows, idx)."""
    rng = np.random.default_rng(fleet_sim.SEED)
    trace = paper_market(seed=29, days=3).window(0, fleet_sim.HORIZON + 1)
    pred = NoisyPredictor(trace, fleet_sim.KIND, fleet_sim.LEVEL,
                          seed=fleet_sim.SEED).matrix(fast_sim.W1MAX - 1)[
        :fleet_sim.HORIZON].astype(np.float32)
    prices = trace.prices[:fleet_sim.HORIZON].astype(np.float32)
    avail = trace.avail[:fleet_sim.HORIZON].astype(np.int64)
    arrivals = rng.integers(0, fleet_sim.ARRIVAL_SPAN, size=fleet_sim.N_JOBS)
    pilot_trace = paper_market(seed=31, days=40)
    pilot_jobs = job_stream_arrays(rng, fleet_sim.PILOT_JOBS,
                                   fleet_sim.DEADLINE)
    t0s = rng.integers(0, len(pilot_trace) - fleet_sim.DEADLINE - 1,
                       size=fleet_sim.PILOT_JOBS)
    seeds = fleet_sim.SEED * 100003 + np.arange(fleet_sim.PILOT_JOBS)
    res = engine.simulate_and_select(
        arrs, pilot_jobs, PAPER_TPUT,
        *engine.prepare_noisy_inputs(pilot_trace, t0s, fleet_sim.DEADLINE,
                                     fleet_sim.KIND, fleet_sim.LEVEL, seeds),
        sharded=False)
    rows, idx = res.admission_rows(arrs, fleet_sim.N_JOBS, rng=rng)
    return prices, avail, pred, arrivals, res, rows, idx


def summary(idx, out, n_pol):
    """(bincount of the admitted lanes, their CRC32, per-slot spot grants,
    jobs finished by the deadline, sum of the utilities)."""
    idx = np.asarray(idx, np.int32)
    return (tuple(int(c) for c in np.bincount(idx, minlength=n_pol)),
            zlib.crc32(idx.tobytes()),
            tuple(int(g) for g in np.asarray(out["n_spot"]).sum(axis=0)),
            int(np.asarray(out["completed"]).sum()),
            float(np.asarray(out["utility"], np.float64).sum()))


def main():
    arrs = specs_to_arrays(paper_pool() + rand_deadline_pool()
                           + baseline_specs())
    n_pol = len(arrs["kind"])
    t0 = time.perf_counter()
    prices, avail, pred, arrivals, res, rows, idx = workload(arrs)
    print(f"# pilot and admission: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    jobs = fast_sim.stack_jobs([PAPER_JOB] * fleet_sim.N_JOBS)
    refs = {"pilot": (res.best_policy(), res.iters_to_half())}
    for name in ("sampled", "greedy"):
        if name == "greedy":
            rows, idx = res.admission_rows(arrs, fleet_sim.N_JOBS,
                                           greedy=True)
        t0 = time.perf_counter()
        out = fleet.simulate_fleet(rows, jobs, arrivals, PAPER_TPUT, prices,
                                   avail, pred)
        refs[name] = summary(idx, out, n_pol)
        print(f"# {name} fleet: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    print("JAX_FLEET = {")
    for name, row in refs.items():
        print(f"    {name!r}: {row!r},")
    print("}")


if __name__ == "__main__":
    main()
