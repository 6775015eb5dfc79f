"""Training launcher: elastic scheduler-driven LoRA fine-tuning (the
reference's ``launch/train.py``, with ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-100m \\
        --smoke --policy ahap --steps-per-unit 2 --deadline 6

Runs on the CUDA card unless given ``--device cpu``; the AHAP policy solves
its windows on the same device (K1 on the card).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.configs.base import JobConfig
from repro_torch.core.market import vast_like_trace
from repro_torch.core.policies import (AHANP, AHANPParams, AHAP, AHAPParams,
                                       MSU, ODOnly, UP)
from repro_torch.core.predictor import (ARIMAPredictor, NoisyPredictor,
                                        PerfectPredictor)
from repro_torch.core.throughput import calibrate
from repro_torch.train.elastic import ElasticTrainer

POLICIES = {
    "ahap": lambda a: AHAP(AHAPParams(a.omega, a.commit, a.sigma),
                           device=a.device),
    "ahanp": lambda a: AHANP(AHANPParams(a.sigma)),
    "od": lambda a: ODOnly(),
    "msu": lambda a: MSU(),
    "up": lambda a: UP(),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-100m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--policy", default="ahap", choices=sorted(POLICIES))
    ap.add_argument("--predictor", default="arima",
                    choices=["perfect", "arima", "noisy"])
    ap.add_argument("--noise", type=float, default=0.2)
    ap.add_argument("--omega", type=int, default=3)
    ap.add_argument("--commit", type=int, default=1)
    ap.add_argument("--sigma", type=float, default=0.7)
    ap.add_argument("--workload", type=float, default=16.0)
    ap.add_argument("--deadline", type=int, default=6)
    ap.add_argument("--n-max", type=int, default=8)
    ap.add_argument("--value", type=float, default=40.0)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps-per-unit", type=float, default=2.0)
    ap.add_argument("--bandwidth-mbps", type=float, default=800.0)
    ap.add_argument("--market-seed", type=int, default=0)
    ap.add_argument("--report", default="")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                       lr=args.lr, total_steps=10_000)
    job = JobConfig(workload=args.workload, deadline=args.deadline,
                    n_min=1, n_max=args.n_max, value=args.value)
    tput = calibrate(cfg, bandwidth_bps=args.bandwidth_mbps * 1e6)
    trace = vast_like_trace(seed=args.market_seed, days=2)
    pred = None
    if args.policy == "ahap":
        predictor = {
            "perfect": lambda: PerfectPredictor(trace),
            "arima": lambda: ARIMAPredictor(trace),
            "noisy": lambda: NoisyPredictor(trace, "fixed_uniform",
                                            args.noise),
        }[args.predictor]()
        pred = predictor.matrix(5)

    policy = POLICIES[args.policy](args)
    trainer = ElasticTrainer(
        cfg, tcfg, job, tput, policy, trace, pred,
        steps_per_unit=args.steps_per_unit,
        bandwidth_bps=args.bandwidth_mbps * 1e6, ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    rep = trainer.run()
    print(f"[train] {cfg.name} policy={args.policy} "
          f"utility={rep.utility:.2f} cost={rep.cost:.2f} "
          f"T={rep.completion_time:.2f}/{job.deadline} steps={rep.total_steps} "
          f"loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}")
    for s in rep.slots:
        print(f"  slot {s.t}: od={s.n_od} spot={s.n_spot} price={s.price:.2f} "
              f"mu={s.mu:.2f} steps={s.steps} loss={s.mean_loss:.3f} "
              f"reconfig={s.reconfig_s:.1f}s")
    if args.report:
        with open(args.report, "w") as f:
            json.dump({
                "utility": rep.utility, "cost": rep.cost,
                "completion_time": rep.completion_time,
                "total_steps": rep.total_steps, "losses": rep.losses,
            }, f)
    return rep


if __name__ == "__main__":
    main()
