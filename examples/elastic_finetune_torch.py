"""End-to-end run of the PyTorch / CUDA port: LoRA fine-tune a
~134M-parameter model for a few hundred optimizer steps, with the paper's
AHAP scheduler deciding the instance allocation each market slot.

    PYTHONPATH=src python examples/elastic_finetune_torch.py [--quick] \\
        [--device cuda]

The counterpart of ``examples/elastic_finetune.py``. The global batch stays
fixed while the instance count varies, so the loss curve is the one a real
elastic cluster would produce; reconfigurations do a real checkpoint save
and restore. The model is drawn from ``TrainConfig.seed`` on ``--device``
(default: the CUDA card, where K2 runs the LoRA projections forward and
backward, K3 attention, and K1 the AHAP policy's window solves).
"""
import argparse

from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.configs.base import JobConfig
from repro_torch.core.market import vast_like_trace
from repro_torch.core.policies import AHAP, AHAPParams
from repro_torch.core.predictor import ARIMAPredictor
from repro_torch.core.throughput import calibrate, tokens_per_slot
from repro_torch.device import resolve_device
from repro_torch.train.elastic import ElasticTrainer

# the scheduler: AHAP with prediction window 3, commitment 1, sigma 0.7
POLICY = AHAPParams(omega=3, v=1, sigma=0.7)


def setting(quick: bool):
    """(model config, train config, job, steps per workload unit)."""
    if quick:
        cfg = get_smoke_config("tiny-100m")
        tcfg = TrainConfig(seq_len=64, global_batch=4, lr=2e-3,
                           total_steps=64)
        job = JobConfig(workload=12, deadline=5, n_min=1, n_max=6,
                        value=30.0)
        return cfg, tcfg, job, 1.5
    cfg = get_config("tiny-100m")  # ~134M params
    tcfg = TrainConfig(seq_len=128, global_batch=8, lr=1e-3, total_steps=400)
    job = JobConfig(workload=50, deadline=8, n_min=1, n_max=10, value=80.0)
    return cfg, tcfg, job, 5.0  # -> a few hundred steps across the job


def build(quick: bool, device=None, ckpt_dir=None) -> ElasticTrainer:
    """The example's trainer: AHAP(POLICY) on ``vast_like_trace(seed=4,
    days=2)`` with ARIMA forecasts, the switching cost calibrated at
    800 Mbps."""
    dev = resolve_device(device)
    cfg, tcfg, job, spu = setting(quick)
    tput = calibrate(cfg, bandwidth_bps=800e6)
    market = vast_like_trace(seed=4, days=2)
    pred = ARIMAPredictor(market).matrix(5)
    policy = AHAP(POLICY, device=dev)
    return ElasticTrainer(cfg, tcfg, job, tput, policy, market, pred,
                          steps_per_unit=spu, ckpt_dir=ckpt_dir, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="reduced model + fewer steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    trainer = build(args.quick, args.device, args.ckpt_dir)
    cfg, tput, job = trainer.cfg, trainer.tput, trainer.job
    print(f"model={cfg.name} ({cfg.param_count()/1e6:.0f}M params, "
          f"LoRA {cfg.lora_param_count()/1e6:.2f}M trainable) on "
          f"{trainer.device}")
    print(f"switching: mu1={tput.mu1:.3f} mu2={tput.mu2:.3f} "
          f"(~{tokens_per_slot(cfg)/1e6:.1f}M tokens/slot/instance at "
          "calibrate's default 197 TFLOP/s and 40% MFU)")
    report = trainer.run()

    print(f"\nutility={report.utility:.2f} cost={report.cost:.2f} "
          f"T={report.completion_time:.2f}/{job.deadline} slots, "
          f"{report.total_steps} optimizer steps")
    print(f"loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    print(f"\n{'slot':>4s} {'od':>3s} {'spot':>4s} {'price':>6s} {'mu':>5s} "
          f"{'steps':>5s} {'loss':>7s} {'ckpt':>9s}")
    for s in report.slots:
        print(f"{s.t:4d} {s.n_od:3d} {s.n_spot:4d} {s.price:6.2f} "
              f"{s.mu:5.2f} {s.steps:5d} {s.mean_loss:7.3f} "
              f"{s.ckpt_bytes:9d}")
    return report


if __name__ == "__main__":
    main()
