"""Online policy selection over the full 112-policy pool (paper Sec. V), on
the PyTorch / CUDA port.

    PYTHONPATH=src python examples/policy_selection_torch.py [--jobs 400]
                                                              [--device cuda]

Streams fine-tuning jobs through the EG selector; every job evaluates the
whole pool in one ``fast_sim.simulate_pool`` call (on the card, one window
solve launch a market slot). Prints the regret trajectory against the
Theorem-2 bound and the final winner. The same loop as
``examples/policy_selection.py`` (the JAX package's), draw for draw.
"""
import argparse

import numpy as np

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core import fast_sim
from repro_torch.core.job import normalize_utility
from repro_torch.core.market import vast_like_trace
from repro_torch.core.policy_pool import (baseline_specs, paper_pool,
                                          specs_to_arrays)
from repro_torch.core.predictor import NoisyPredictor
from repro_torch.core.selector import (best_policy, init_selector, regret,
                                       regret_bound, select, update)
from repro_torch.device import resolve_device

TPUT = ThroughputConfig(mu1=0.9, mu2=0.95)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    k_jobs, dev = args.jobs, resolve_device(args.device)

    pool = paper_pool() + baseline_specs()          # 112 + 3
    arrs = specs_to_arrays(pool)
    market = vast_like_trace(seed=3, days=40, mean_price=0.7,
                             price_sigma=0.5, avail_mean=5.5,
                             avail_season_amp=3.0)
    rng = np.random.default_rng(0)
    st = init_selector(len(pool), k_jobs)

    for k in range(k_jobs):
        job = JobConfig(workload=float(rng.uniform(70, 120)), deadline=10,
                        n_min=int(rng.integers(1, 4)),
                        n_max=int(rng.integers(12, 17)), value=120.0)
        tr = market.window(int(rng.integers(0, len(market) - 11)), 11)
        pred = NoisyPredictor(tr, "fixed_uniform", 0.15, seed=k).matrix(5)
        prices, avail, pm = fast_sim.prepare_inputs(tr, pred, job.deadline)
        chosen = select(st, rng)  # noqa: F841 (the policy job k would run)
        out = fast_sim.simulate_pool(arrs, fast_sim.JobArrays.of(job), TPUT,
                                     prices, avail, pm, device=dev)
        u = normalize_utility(job, out["utility"]).cpu().numpy()
        st = update(st, u)
        if (k + 1) % 50 == 0:
            b = best_policy(st)
            print(f"job {k+1:4d}: regret={regret(st):7.2f} "
                  f"bound={regret_bound(len(pool), k+1):7.2f} "
                  f"leader={pool[b].name} (w={st.weights[b]:.2f})")

    b = best_policy(st)
    bound = regret_bound(len(pool), k_jobs)
    print(f"\nselected policy after {k_jobs} jobs: {pool[b].name} "
          f"(weight {st.weights[b]:.3f})")
    print(f"final regret {regret(st):.2f} <= bound {bound:.2f}: "
          f"{regret(st) <= bound}")


if __name__ == "__main__":
    main()
