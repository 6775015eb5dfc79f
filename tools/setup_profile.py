"""Times a benchmark cell's set-up on the card, part by part, and with
``--profile`` prints where each of its two train steps spends its time.

    python3 tools/setup_profile.py --workload lora.mamba2-370m.b24s2k \\
        --seed 3000007919 [--profile]

from the root of a checkout, on a machine with a CUDA card. It runs the
cell's set-up as ``port_bench`` does (the kernels built side by side, the
weights drawn on the card, the train step built, then two steps on the
window's feed), each part followed by a synchronize and timed on the
host clock: the build, the draw, and for each step its batch (the feed)
and the step apart. With ``--profile`` each step's batch and step run
under a ``torch.profiler`` profile of their own, started and stopped
(each timed) outside the timed parts, and the step's ten host events with
the most self time follow it (the profiler slows what it records: time
without it).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from port_bench import (catalog, program, run, train_check,  # noqa: E402
                        weights)
from port_bench.drivers import lora_train  # noqa: E402


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _top(prof, n: int = 10) -> None:
    from torch.autograd import DeviceType

    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation())
    print(f"  device busy {busy / 1e9:.3f} s; host events by self time:")
    for a in sorted(prof.key_averages(),
                    key=lambda a: -a.self_cpu_time_total)[:n]:
        print(f"    {a.key[:70]:70s} {a.count:7d}x "
              f"{a.self_cpu_time_total / 1e6:8.3f} s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/setup_profile.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("setup_profile: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    ctx = run.resolve(bench, args.workload, catalog.ROOT)
    model, traffic = ctx.model, ctx.traffic
    _, s = _timed(lambda: program.prebuild(model, dev))
    print(f"{args.workload} on {torch.cuda.get_device_name(0)}: kernels "
          f"built in {s:.3f} s")
    flat, s = _timed(lambda: weights.draw_all(model, args.seed, dev))
    params = weights.program_tree(flat)
    del flat
    (step, init_opt), s2 = _timed(lambda: program.train_step(model,
                                                             traffic))
    opt, s3 = _timed(lambda: init_opt(params))
    print(f"weights drawn in {s:.3f} s, the step built in {s2:.3f} s, "
          f"its optimizer state in {s3:.3f} s")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for k in range(lora_train.SETUP_STEPS):
        prof = profile(activities=acts) if args.profile else None
        if prof is not None:
            _, s0 = _timed(prof.start)
        (tok, tgt), s = _timed(lambda: train_check.feed(
            model, traffic, args.seed, k, dev))
        (params, opt, m), s2 = _timed(lambda: step(
            params, opt, {"tokens": tok, "targets": tgt}))
        print(f"step {k}: batch {s:.3f} s, step {s2:.3f} s "
              f"(loss {float(m.loss):.4f})")
        if prof is not None:
            _, s3 = _timed(prof.stop)
            print(f"  the profiler started in {s0:.3f} s, stopped in "
                  f"{s3:.3f} s")
            _top(prof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
