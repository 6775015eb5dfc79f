"""Roofline over the dry run's records, with an NVIDIA H100's peaks (the
JAX package's ``launch/roofline.py``).

Per (arch x shape x mesh) record, per device and step:
    compute term    = dot FLOPs / PEAK_FLOPS_BF16
    memory term     = traffic bytes / HBM_BW
    collective term = collective bytes / LINK_BW
The counts are per device already (``launch.op_analysis``). The memory
and collective terms take the true byte counts, not the bf16-equivalent
ones the reference takes to undo its CPU backend's f32 promotion: the
port's f32 tensors are f32 on the card too. The bound of a step is the
largest term. The compute term is a strict lower bound of a run of the
counted path; the memory term counts each op's operands and results once
at the HBM rate, which the 50 MB L2 can beat where they fit in it. The
records count the plain kernel versions, which move more than the
kernels (``dryrun.count(kernels=True)`` counts the card's path).

MODEL_FLOPS = 6 N D (LoRA train: forward, remat forward, activation-grad
backward), 2 N D for prefill and 2 N D_step for decode, N the active
parameters; the MODEL / counted ratio shows remat and dispatch waste.

Usage:  PYTHONPATH=src python -m repro_torch.launch.roofline \\
            [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


def model_flops_per_device(arch, shape, devices: int) -> float:
    """Useful (algorithmic) matmul FLOPs per device per step. ``arch`` is
    an arch id or a ModelConfig, ``shape`` a shape name or a
    ShapeConfig."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        total = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        total = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:  # decode: ONE token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / devices


def terms(flops: float, mem_bytes: float, coll_bytes: float) -> dict:
    """The three roofline terms in seconds, their largest (``bound_s``)
    and the term that sets it (``dominant``)."""
    t = {"compute": flops / PEAK_FLOPS_BF16, "memory": mem_bytes / HBM_BW,
         "collective": coll_bytes / LINK_BW}
    dominant = max(t, key=t.get)
    return {"compute_s": t["compute"], "memory_s": t["memory"],
            "collective_s": t["collective"], "dominant": dominant,
            "bound_s": t[dominant]}


def analyze_record(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    dev = rec["devices"]
    flops = rec["flops_per_device"]
    t = terms(flops, rec["bytes_per_device"], rec["collective_bytes"])
    mf = model_flops_per_device(rec["arch"], rec["shape"], dev)
    bound = t["bound_s"]
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "devices": dev,
        "compute_s": t["compute_s"],
        "memory_s": t["memory_s"],
        "collective_s": t["collective_s"],
        "dominant": t["dominant"],
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / flops if flops else 0.0,
        "step_bound_s": bound,
        "mfu_upper_bound": (mf / PEAK_FLOPS_BF16) / bound if bound > 0
        else 0.0,
    }


def suggest(row: dict) -> str:
    """One sentence on what would move the dominant term down."""
    d = row["dominant"]
    if d == "collective":
        return ("reduce TP-activation all-reduces: sequence-parallel "
                "(reduce-scatter+all-gather) or a narrower model axis")
    if d == "memory":
        return ("raise arithmetic intensity: larger per-step tile/batch, "
                "fuse elementwise chains, or cast f32 paths to bf16")
    return ("compute-bound: shave redundant FLOPs (remat policy, capacity "
            "factor) or accept: near roofline")


def load_dir(path: str):
    recs = []
    for f in sorted(os.listdir(path)):
        if f.endswith(".json"):
            with open(os.path.join(path, f)) as fh:
                recs.append(json.load(fh))
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16",
                    help="mesh filter (16x16 | 2x16x16 | all)")
    ap.add_argument("--json-out", default="experiments/roofline_torch.json")
    args = ap.parse_args()

    rows = []
    skipped = []
    for rec in load_dir(args.dir):
        if args.mesh != "all" and rec.get("mesh") != args.mesh:
            continue
        r = analyze_record(rec)
        if r is None:
            skipped.append((rec["arch"], rec["shape"],
                            rec.get("reason", rec.get("error", ""))))
            continue
        r["suggestion"] = suggest(r)
        rows.append(r)

    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'collect_s':>10s} {'dominant':>10s} {'useful':>7s} "
           f"{'MFU_ub':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:10.4f} "
              f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
              f"{r['dominant']:>10s} {r['useful_flops_ratio']:7.3f} "
              f"{r['mfu_upper_bound']:7.3f}")
    for a, s, why in skipped:
        print(f"{a:22s} {s:12s} SKIPPED: {why}")

    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"\nwrote {args.json_out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
