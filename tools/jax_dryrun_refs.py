"""Record the JAX package's per-device dry-run counts, which chip_smoke.py's
``[dryrun]`` and tests/test_torch_dryrun_sharded.py hold the PyTorch port's
sharded counts against.

    PYTHONPATH=src python tools/jax_dryrun_refs.py
    PYTHONPATH=src python tools/jax_dryrun_refs.py --smoke \\
        --combo olmo-1b:train_4k:single --combo mixtral-8x7b:train_4k:multi \\
        --json /tmp/refs.json

With no ``--smoke`` it counts olmo-1b x train_4k on the (16, 16) production
mesh (256 host devices, about a minute) and prints ``JAX_DRYRUN`` as
chip_smoke.py holds it. ``--smoke`` counts each ``--combo``
(``arch:shape:single|multi``) on the smoke config and the (2, 2) or
(2, 2, 2) mesh (8 host devices, 5-10 s each) and writes the records to
``--json``.

The counts are ``repro.launch.dryrun.run_one``'s: the loop-aware dots,
traffic and collectives of the SPMD-partitioned HLO
(``repro.launch.hlo_analysis.analyze``). On JAX 0.9 ``jax.make_mesh``
makes Explicit axes, which the package's ``with_sharding_constraint``
refuses; this script makes every mesh with Auto axes (the partitioner
propagates the shardings, as the package was written for) by wrapping
``jax.make_mesh`` for its own process. Nothing in the package changes.
The device count is set before JAX starts, so each run is a process of
its own.
"""
import argparse
import json
import os
import sys
import time

KEYS = ("flops_per_device", "collective_bytes", "collective_bytes_bf16eq",
        "bytes_per_device", "bytes_per_device_bf16eq")


def _auto_axes() -> None:
    """``jax.make_mesh`` with Auto axes unless the caller names them."""
    import jax

    make_mesh = jax.make_mesh
    if getattr(make_mesh, "auto_axes", False) or not hasattr(
            jax.sharding, "AxisType"):
        return

    def auto(shape, names, **kw):
        kw.setdefault("axis_types",
                      (jax.sharding.AxisType.Auto,) * len(shape))
        return make_mesh(shape, names, **kw)

    auto.auto_axes = True
    jax.make_mesh = auto


def run(combos, smoke: bool) -> list:
    """One record of ``repro.launch.dryrun.run_one`` for each (arch,
    shape, multi_pod)."""
    os.environ["REPRO_DRYRUN_DEVICES"] = "8" if smoke else (
        "512" if any(mp for _, _, mp in combos) else "256")
    from repro.launch import dryrun  # sets XLA_FLAGS before JAX starts

    _auto_axes()
    recs = []
    for arch, shape, multi_pod in combos:
        t0 = time.time()
        rec = dryrun.run_one(arch, shape, multi_pod, verbose=False,
                             smoke=smoke)
        rec["wall_s"] = round(time.time() - t0, 2)
        recs.append(rec)
        print(f"[jax_dryrun_refs] {arch} x {shape} x {rec['mesh']}: "
              f"{rec['status']} in {rec['wall_s']} s", file=sys.stderr)
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs on a (2, 2) / (2, 2, 2) mesh")
    ap.add_argument("--combo", action="append", default=[],
                    help="arch:shape:single|multi (repeatable)")
    ap.add_argument("--json", default="", help="write the records here")
    args = ap.parse_args()
    if args.smoke:
        combos = [(a, s, m == "multi") for a, s, m in
                  (c.split(":") for c in args.combo)]
    else:
        combos = [("olmo-1b", "train_4k", False)]
    recs = run(combos, args.smoke)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(recs, f, indent=1)
    if not args.smoke:
        r = recs[0]
        print("JAX_DRYRUN = {")
        print(f"    'combination': ({r['arch']!r}, {r['shape']!r}, "
              f"{r['mesh']!r}),")
        for k in KEYS:
            print(f"    {k!r}: {r[k]!r},")
        print("}")


if __name__ == "__main__":
    main()
