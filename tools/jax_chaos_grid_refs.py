"""Record the JAX package's results on chip_smoke.py's ``[chaos]`` and
``[grid]`` phases, which hold the PyTorch port to them on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_chaos_grid_refs.py

Runs the reference (``repro``) on the CPU at the phases' full size: the
chaos sweep's storm regime (``benchmarks/chaos_sweep.build_inputs``) at
1000 jobs x the 124-lane pool for 0, 1 and 2 storms, each without and with
the fallback monitor (the monitor run with ``collect=True``; collect only
adds outputs), and the scenario grid's 48 regimes x 16 jobs
(``benchmarks/scenario_grid``), one ``collect=True`` pass. Prints the
``JAX_CHAOS`` and ``JAX_GRID`` constants as chip_smoke.py holds them.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmarks import chaos_sweep, scenario_grid  # noqa: E402
from benchmarks.common import PAPER_TPUT  # noqa: E402
from repro.chaos import FallbackConfig  # noqa: E402
from repro.configs.base import ThroughputConfig  # noqa: E402
from repro.core import engine  # noqa: E402
from repro.core.policy_pool import (KIND_AHAP, baseline_specs,  # noqa: E402
                                    paper_pool, rand_deadline_pool,
                                    specs_to_arrays)
from repro.obs import grid_ledger, pool_ledger, selection_ledger  # noqa: E402

N_CHAOS_JOBS = 1000


def main():
    pool = paper_pool() + rand_deadline_pool() + baseline_specs()
    arrs = specs_to_arrays(pool)
    ahap = np.asarray(arrs["kind"]) == KIND_AHAP
    cfg = FallbackConfig(threshold=0.5, lam=0.5)
    chaos = {}
    for n_storms in (0, 1, 2):
        t0 = time.perf_counter()
        jobs, pw, aw, preds, _ = chaos_sweep.build_inputs(n_storms,
                                                          N_CHAOS_JOBS)
        run = lambda **kw: engine.simulate_and_select(
            arrs, jobs, PAPER_TPUT, pw, aw, preds, sharded=False, **kw)
        off, on = run(), run(fallback=cfg, collect=True)
        fb = pool_ledger(on.sim_out, jobs, PAPER_TPUT)["fallback"]
        sel = selection_ledger(on)
        chaos[n_storms] = {
            "off": (off.best_policy(), off.iters_to_half(),
                    off.regret_ratio(),
                    float(off.mean_utility[ahap].mean())),
            "on": (on.best_policy(), on.iters_to_half(), on.regret_ratio(),
                   float(on.mean_utility[ahap].mean())),
            "events": (fb["triggers"], fb["recoveries"],
                       sel["top_policy"]["n_switches"]),
        }
        assert fb["events_reconciled"]
        print(f"# chaos s={n_storms}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    t0 = time.perf_counter()
    regimes = scenario_grid.grid_regimes()
    jobs, prices, avail, preds, _ = scenario_grid.build_grid_inputs(regimes)
    util, sim_out = scenario_grid.evaluate_grid(
        arrs, regimes, jobs, prices, avail, preds, collect=True)
    res = scenario_grid.analyze_grid(pool, regimes, util, jobs)
    tputs = [ThroughputConfig(alpha=PAPER_TPUT.alpha, beta=PAPER_TPUT.beta,
                              mu1=r.mu1, mu2=r.mu2) for r in regimes]
    led = grid_ledger([{"key": r.key} for r in regimes], util, sim_out,
                      jobs, tputs, util.shape[1])
    print(f"# grid: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print("JAX_CHAOS = {")
    for s, row in chaos.items():
        print(f"    {s}: {row!r},")
    print("}")
    print(f"JAX_GRID = ({res['winner_idx'].tolist()!r}, "
          f"{res['fixed_best']})")
    print(f"# grid_ledger worst residuals: cost "
          f"{led['max_abs_cost_residual']!r}, utility "
          f"{led['max_abs_utility_residual']!r}")


if __name__ == "__main__":
    main()
