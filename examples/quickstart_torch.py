"""Quickstart on the PyTorch / CUDA port: schedule one fine-tuning job on a
synthetic spot market.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]

The paper's pipeline end to end, as ``examples/quickstart.py`` walks it on
the JAX package: build a market, forecast it with ARIMA, run AHAP / AHANP
and the three baselines through the reference simulator, and compare
against the offline optimum. AHAP's window solves run on ``--device``
(default: the CUDA card, one launch of the window-DP kernel a decision).
"""
import argparse

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.market import TraceStats, vast_like_trace
from repro_torch.core.offline_opt import solve_offline
from repro_torch.core.policies import (AHANP, AHANPParams, AHAP, AHAPParams,
                                       MSU, ODOnly, UP)
from repro_torch.core.predictor import ARIMAPredictor
from repro_torch.core.simulator import simulate
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # the paper's evaluation job (Sec. VI-A): LLaMA2-7B LoRA, 80 units / 10
    # slots
    job = JobConfig(workload=80, deadline=10, n_min=1, n_max=12, value=120.0)
    tput = ThroughputConfig(alpha=1.0, beta=0.0, mu1=0.9, mu2=0.95)

    # a Vast.ai-like A100 spot market (30-min slots)
    market = vast_like_trace(seed=7, days=12, mean_price=0.7, price_sigma=0.5,
                             avail_mean=5.5, avail_season_amp=3.0)
    print("market:", TraceStats.of(market))

    # forecast it (seasonal-AR 'ARIMA', fit on the first 10 days)
    t0 = 10 * 48  # schedule the job on day 11
    window = market.window(t0, job.deadline + 1)
    hist = market.window(0, t0 + job.deadline + 1)
    pred_full = ARIMAPredictor(hist).matrix(5)
    pred = pred_full[t0 : t0 + job.deadline]

    print(f"\n{'policy':10s} {'utility':>8s} {'cost':>7s} {'T':>6s} "
          f"{'done':>5s}  allocation")
    for pol in [AHAP(AHAPParams(omega=3, v=1, sigma=0.7), device=dev),
                AHANP(AHANPParams(sigma=0.7)), ODOnly(), MSU(), UP()]:
        r = simulate(pol, job, tput, window,
                     pred if pol.name == "ahap" else None)
        print(f"{pol.name:10s} {r.utility:8.2f} {r.cost:7.2f} "
              f"{r.completion_time:6.2f} {str(r.completed_by_deadline):>5s}  "
              f"{list(r.n_total)}")

    opt = solve_offline(job, tput, window)
    print(f"{'OPT':10s} {opt.utility:8.2f} {opt.cost:7.2f}              "
          f"{list(opt.plan_total)}")


if __name__ == "__main__":
    main()
