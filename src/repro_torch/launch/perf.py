"""Hillclimb runner: one (arch x shape) dry run under named variants,
its roofline terms against the first's (the JAX package's
``launch/perf.py``).

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --arch qwen1.5-110b --shape train_4k --variants baseline,mb8,seqpar

Each variant is a (microbatches, sharding rules, config) override; the
records land in experiments/perf_torch/.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_one
from repro_torch.launch.roofline import analyze_record

VARIANTS = {
    "baseline": {},
    # --- train: microbatch count (weight-gather amortization vs peak) ---
    "mb8": {"microbatches": 8},
    "mb4": {"microbatches": 4},
    "mb2": {"microbatches": 2},
    # --- sequence parallelism: shard the residual stream's seq dim over
    # the model axis (norms / elementwise stop being replicated across the
    # tensor axis) ---
    "seqpar": {"rules": {"seq": ("model",)}},
    "seqpar_mb8": {"rules": {"seq": ("model",)}, "microbatches": 8},
    # --- decode cache placement ---
    "cache_replicated": {"rules": {"kv_seq": ()}},
    "cache_batch": {"rules": {"kv_seq": (),
                              "batch": ("pod", "data", "model")}},
    # --- keep base weights un-sharded over data (pure 16-way TP) ---
    "no_fsdp": {"rules": {"fsdp": ()}},
    # --- MoE experts sharded over the data axis (expert parallelism) ---
    "expert_par": {"rules": {"experts": ("data",)}},
    # --- pad attention heads to the next multiple of the model axis: 28
    # heads on a 16-way axis fall back to full replication. Zero padding
    # heads keep the function; only the sharding changes (qwen2-vl-7b) ---
    "head_pad32": {"cfg": {"num_heads": 32, "head_dim": 128}},
    "head_pad32_no_fsdp": {"cfg": {"num_heads": 32, "head_dim": 128},
                           "rules": {"fsdp": ()}},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/perf_torch")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    rows = []
    for name in args.variants.split(","):
        ov = VARIANTS[name]
        rec = run_one(
            args.arch, args.shape, args.multi_pod, verbose=True,
            microbatches=ov.get("microbatches"),
            rules=ov.get("rules"), variant=name,
            cfg_overrides=ov.get("cfg"),
        )
        fname = f"{args.arch}_{args.shape}_{rec['mesh']}_{name}.json" \
            .replace("/", "-")
        with open(os.path.join(args.out, fname), "w") as f:
            json.dump(rec, f, indent=2)
        r = analyze_record(rec)
        if r is None:
            print(f"{name}: SKIPPED: {rec.get('reason')}")
            continue
        temp = rec["memory"]["temp_size_in_bytes"] / 2**30
        rows.append((name, r, temp))

    print(f"\n{'variant':18s} {'compute_s':>10s} {'memory_s':>10s} "
          f"{'collect_s':>10s} {'bound_s':>9s} {'tempGiB':>8s} "
          f"{'dominant':>10s}")
    base = rows[0][1] if rows else None
    for name, r, temp in rows:
        d = ""
        if base is not None and r is not base:
            change = 100 * (r["step_bound_s"] / base["step_bound_s"] - 1)
            d = f"  ({change:+.1f}% bound)"
        print(f"{name:18s} {r['compute_s']:10.4f} {r['memory_s']:10.4f} "
              f"{r['collective_s']:10.4f} {r['step_bound_s']:9.4f} "
              f"{temp:8.2f} {r['dominant']:>10s}{d}")


if __name__ == "__main__":
    main()
