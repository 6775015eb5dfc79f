"""Two more surfaces of the PyTorch / CUDA port in one script:

1. batched SERVING of a fine-tuned MoE checkpoint (prefill and greedy
   decode with the ring-buffer KV cache), and
2. MULTI-JOB scheduling: fine-tuning jobs with different deadlines
   competing for the same spot pool (least-slack-first arbitration, the
   paper's stated Sec. III-A extension).

    PYTHONPATH=src python examples/serve_and_multijob_torch.py [--device cuda]

The counterpart of ``examples/serve_and_multijob.py``. The model's weights
are random, drawn from a numpy seed (``convert.random_model_params``); the
python AHAP policies solve their windows on ``--device`` (default: the CUDA
card, one launch of the window-DP kernel a decision).
"""
import argparse

import numpy as np

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.market import vast_like_trace
from repro_torch.core.multi_job import MultiJobScheduler
from repro_torch.core.policies import AHAP, AHAPParams
from repro_torch.core.predictor import ARIMAPredictor
from repro_torch.device import resolve_device
from repro_torch.serve import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1. serving -----------------------------------------------------
    cfg = get_smoke_config("mixtral-8x7b")  # MoE + sliding-window attention
    params = convert.model_params(convert.random_model_params(cfg, 0), cfg,
                                  dev)
    engine = ServingEngine(cfg, params, max_len=128, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 12))
    outs = engine.generate_batch([Request(prompt=p, max_new_tokens=8)
                                  for p in prompts])
    print("serving (mixtral smoke, batch=4, SWA ring cache):")
    for i, o in enumerate(outs):
        print(f"  req{i}: prompt[:4]={[int(t) for t in prompts[i][:4]]} -> "
              f"generated {[int(t) for t in o]}")

    # --- 2. multi-job scheduling ----------------------------------------
    tput = ThroughputConfig(mu1=0.9, mu2=0.95)
    market = vast_like_trace(seed=9, days=3, mean_price=0.7, price_sigma=0.5,
                             avail_mean=6.0, avail_season_amp=3.0)
    pred = ARIMAPredictor(market).matrix(5)
    sched = MultiJobScheduler(tput, market)

    jobs = [
        (0, JobConfig(workload=60, deadline=8, n_min=1, n_max=12,
                      value=100.0), "tight"),
        (0, JobConfig(workload=40, deadline=14, n_min=1, n_max=10,
                      value=80.0), "loose"),
        (3, JobConfig(workload=50, deadline=10, n_min=1, n_max=12,
                      value=90.0), "late-arrival"),
    ]
    names = {}
    for arr, job, tag in jobs:
        jid = sched.submit(arr, job, AHAP(AHAPParams(3, 1, 0.7), device=dev),
                           pred=pred)
        names[jid] = tag

    results = sched.run(30)
    print("\nmulti-job (shared spot pool, least-slack-first):")
    print(f"{'job':>14s} {'utility':>8s} {'cost':>7s} {'T':>6s} "
          f"{'on-time':>7s}")
    for r in sorted(results, key=lambda r: r.job_id):
        print(f"{names[r.job_id]:>14s} {r.utility:8.2f} {r.cost:7.2f} "
              f"{r.completion_time:6.2f} {str(r.completed_by_deadline):>7s}")


if __name__ == "__main__":
    main()
