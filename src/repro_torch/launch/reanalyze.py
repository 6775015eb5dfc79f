"""Count the saved op logs again (``dryrun --trace-dir``) and refresh the
dry-run records, so an accounting change needs no new run (the JAX
package's ``launch/reanalyze.py``).

    PYTHONPATH=src python -m repro_torch.launch.reanalyze \\
        --trace-dir experiments/ops_torch --dryrun-dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.op_analysis import analyze, load_log

SUFFIX = ".ops.z"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default="experiments/ops_torch")
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    args = ap.parse_args()

    n = 0
    for f in sorted(os.listdir(args.trace_dir)):
        if not f.endswith(SUFFIX):
            continue
        base = f[: -len(SUFFIX)]
        jpath = os.path.join(args.dryrun_dir, base + ".json")
        if not os.path.exists(jpath):
            print(f"skip {base}: no JSON record")
            continue
        log, meta = load_log(os.path.join(args.trace_dir, f))
        acc = analyze(log, meta.get("while_trips", ()))
        with open(jpath) as fh:
            rec = json.load(fh)
        rec.update(
            flops_per_device=float(acc["dot_flops"]),
            bytes_per_device=float(acc["traffic_bytes"]),
            bytes_per_device_bf16eq=float(acc["traffic_bytes_bf16eq"]),
            collectives=acc["collectives"],
            collective_bytes=float(acc["collective_bytes_total"]),
            collective_bytes_bf16eq=float(acc["collective_bytes_bf16eq"]),
            while_trips=acc["while_trips"],
            unknown_trip_whiles=acc["unknown_trip_whiles"],
        )
        with open(jpath, "w") as fo:
            json.dump(rec, fo, indent=2)
        n += 1
    print(f"re-analyzed {n} records")


if __name__ == "__main__":
    main()
