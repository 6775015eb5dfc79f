"""Reads, on the card and at a cell's own size, the numbers ``correct``
compares, for the limits in ``cells/<workload>.json``: the program's
sound runs over many seeds (the lower reading), the control (the
reference in fp8, ``train_check``, its own expert choices recorded as the
program's are) and the planted faults (``faults``) over a few (the upper
one). Each goes through ``train_check.judge``, the comparison a run
makes, under the cell's limits as they stand, and its ``correct`` is
recorded beside its readings and its worst leaves. One process, the
weights drawn anew for each seed; one JSON line a reading, on standard
output and appended to ``--out``.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--fault-seeds 1,2] [--faults a,b] \\
        [--out file.jsonl]

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from port_bench import catalog, faults, program, run, train_check
from port_bench.drivers import lora_train
from port_bench.reference.moe import Routes


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _worst_leaves(traj: dict, ref: dict, top: int = 3) -> dict:
    out = {}
    for name, keep in (("first_grad", None),
                       ("change", train_check.moved(ref))):
        gaps = train_check.leaf_gaps(traj[name], ref[name], keep)
        out[name] = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--faults", default=",".join(faults.FAULTS))
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    ctx = run.resolve(bench, args.workload, catalog.ROOT)
    ctx.device = "cuda"
    dev = torch.device("cuda")
    model, traffic = ctx.model, ctx.traffic
    program.prebuild(model, dev)
    card = torch.cuda.get_device_name(0)
    limits = ctx.cell["limits"]

    def emit(traj, ref, failed=0, **rec):
        got, _, correct = train_check.judge(traj, ref, failed, limits)
        rec.update(workload=args.workload, card=card, readings=got,
                   correct=correct,
                   worst=ref and _worst_leaves(traj, ref))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds
                               + args.fault_seeds))
    for seed in seeds:
        ctx.seed = seed
        t0 = time.perf_counter()
        st = lora_train.setup(ctx)
        prog, lora0, failed = st["prog"], st["lora0"], st["failed"]
        del st
        _free()
        t1 = time.perf_counter()
        ref = train_check.reference_for(model, traffic, seed, lora0, prog,
                                        dev)
        if seed in args.seeds:
            emit(prog, ref, failed, kind="program", seed=seed,
                 program_s=t1 - t0, reference_s=time.perf_counter() - t1,
                 losses=prog["losses"], ref_losses=ref["losses"])
        del ref
        _free()
        if seed in args.control_seeds:
            t1 = time.perf_counter()
            routes = Routes() if model.get("moe") else None
            ctl = train_check.reference_trajectory(
                model, traffic, seed, lora0, lora_train.SETUP_STEPS, dev,
                "fp8", routes)
            if routes is not None:
                ctl["routes"] = routes.steps()
            ref = train_check.reference_for(model, traffic, seed, lora0, ctl,
                                            dev)
            emit(ctl, ref, kind="control", seed=seed,
                 control_s=time.perf_counter() - t1)
            del ctl, ref
            _free()
        if seed in args.fault_seeds:
            for name in args.faults.split(","):
                st = lora_train.setup(ctx, faults.FAULTS[name])
                traj, failed = st["prog"], st["failed"]
                del st
                _free()
                ref = train_check.reference_for(model, traffic, seed, lora0,
                                                traj, dev)
                emit(traj, ref, failed, kind=f"fault:{name}", seed=seed)
                del ref
                _free()
    print(f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
