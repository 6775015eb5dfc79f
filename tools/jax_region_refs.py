"""Record the JAX package's results on chip_smoke.py's ``[region]`` phase,
which holds the PyTorch port to them on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_region_refs.py

Runs the reference (``repro``) on the CPU at ``benchmarks/region_e2e.py``'s
full size: 1000 jobs x the 36-lane ``region_pool()`` x 3 phase-shifted
regions x 16 slots, fixed-magnitude uniform 10% noise, the regional engine
(``engine.simulate_and_select(delta_mig=1)``) streamed in chunks of 256 jobs
through a ``prepare_noisy_inputs_regions`` closure, once with a flat
on-demand price and once with per-region multipliers (1.0, 1.3, 0.8). Prints
the ``JAX_REGION`` constant as chip_smoke.py holds it: per run, (best_policy,
iters_to_half, regret_ratio, total migrations), and the seconds each run
took on stderr.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import region_e2e  # noqa: E402
from benchmarks.common import PAPER_TPUT  # noqa: E402
from repro.core import engine  # noqa: E402
from repro.core.policy_pool import region_pool, specs_to_arrays  # noqa: E402
from repro.obs import ledger  # noqa: E402

P_OD = (1.0, 1.3, 0.8)


def main():
    arrs = specs_to_arrays(region_pool())
    market, jobs, t0s, seeds = region_e2e._workload()
    prep = lambda lo, hi: engine.prepare_noisy_inputs_regions(
        market, t0s[lo:hi], region_e2e.DEADLINE, region_e2e.KIND,
        region_e2e.LEVEL, seeds[lo:hi])
    refs = {}
    for name, p_od in (("flat", None), ("p_od", P_OD)):
        t0 = time.perf_counter()
        res = engine.simulate_and_select(
            arrs, jobs, PAPER_TPUT, None, None, None, sharded=False,
            delta_mig=market.delta_mig, p_od=p_od,
            job_chunk=region_e2e.CHUNK, prep=prep, collect=True)
        recon = ledger.migration_reconciliation(res.sim_out)
        assert recon["events_reconciled"] and recon["series_matches_leaf"]
        refs[name] = (res.best_policy(), res.iters_to_half(),
                      res.regret_ratio(), recon["total_migrations"])
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print("JAX_REGION = {")
    for name, row in refs.items():
        print(f"    {name!r}: {row!r},")
    print("}")


if __name__ == "__main__":
    main()
