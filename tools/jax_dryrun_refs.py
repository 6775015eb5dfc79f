"""Record the JAX package's per-device dry-run counts, which chip_smoke.py's
``[dryrun]`` and tests/test_torch_dryrun_sharded.py hold the PyTorch port's
sharded counts against.

    PYTHONPATH=src python tools/jax_dryrun_refs.py
    PYTHONPATH=src python tools/jax_dryrun_refs.py --smoke \\
        --combo olmo-1b:train_4k:single --combo mixtral-8x7b:train_4k:multi \\
        --json /tmp/refs.json
    PYTHONPATH=src python tools/jax_dryrun_refs.py --smoke --collectives \\
        --combo zamba2-2.7b:decode_32k:single

With no ``--smoke`` it counts olmo-1b x train_4k on the (16, 16) production
mesh (256 host devices, about a minute) and prints ``JAX_DRYRUN`` as
chip_smoke.py holds it. ``--smoke`` counts each ``--combo``
(``arch:shape:single|multi``) on the smoke config and the (2, 2) or
(2, 2, 2) mesh (8 host devices, 5-10 s each) and writes the records to
``--json``. ``--smoke`` alone also prints ``JAX_DRYRUN_SMOKE`` as chip_smoke.py
holds it, one entry a combination.

``--collectives`` lists, for each combination, every collective of the
reference's partitioned HLO (kind, operand and result shapes, calls counted
through its loops' trip counts, bf16-equivalent bytes, and the op that XLA
derived it from), and beside it the port's, from rank 0's op log of
``python -m repro_torch.launch.dryrun --smoke`` (a subprocess; kind,
operand and result shapes, calls, bytes).

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
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

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


def run(combos, smoke: bool, hlo: dict = None) -> list:
    """One record of ``repro.launch.dryrun.run_one`` for each (arch,
    shape, multi_pod); ``hlo``, when given, gets each one's partitioned
    HLO text under the same key."""
    os.environ["REPRO_DRYRUN_DEVICES"] = "8" if smoke else (
        "512" if any(mp for _, _, mp in combos) else "256")
    from repro.launch import dryrun  # sets XLA_FLAGS before JAX starts

    _auto_axes()
    analyze, texts = dryrun.analyze_hlo, []

    def keep(text, *args, **kwargs):
        texts.append(text)
        return analyze(text, *args, **kwargs)

    dryrun.analyze_hlo = keep
    recs = []
    for combo in combos:
        arch, shape, multi_pod = combo
        t0 = time.time()
        rec = dryrun.run_one(arch, shape, multi_pod, verbose=False,
                             smoke=smoke)
        rec["wall_s"] = round(time.time() - t0, 2)
        recs.append(rec)
        if hlo is not None and texts:
            hlo[combo] = texts.pop()
        print(f"[jax_dryrun_refs] {arch} x {shape} x {rec['mesh']}: "
              f"{rec['status']} in {rec['wall_s']} s", file=sys.stderr)
    dryrun.analyze_hlo = analyze
    return recs


def _layoutless(hlo_type: str) -> str:
    """An HLO type without its layouts ("f32[2,3]{1,0}" -> "f32[2,3]")."""
    return re.sub(r"\{[^}]*\}", "", hlo_type)


def hlo_collectives(text: str) -> dict:
    """{(kind, operand types, result type, where): calls} of every
    collective in a partitioned HLO module, each call counted as often as
    the loops around it run (``hlo_analysis.analyze``'s walk). ``where``
    names the trip counts of the loops around it ("-": none, hoisted out
    of every loop), the pass (forward, backward, or the backward's
    recompute of a remat layer) and the op XLA derived it from."""
    from repro.launch import hlo_analysis as ha

    comps, entry = ha.parse_module(text)
    trips = ha.extract_trip_counts(text, comps)
    out = {}

    def walk(name, mult, loops):
        comp = comps.get(name)
        if comp is None:
            return
        for ins in comp.instrs:
            kind = ins.opcode.removesuffix("-start")
            if kind in ha.COLLECTIVE_KINDS:
                src = re.search(r'op_name="([^"]*)"', ins.attrs)
                src = src.group(1) if src else ""
                phase = ("recompute" if "rematted_computation" in src
                         else "backward" if "transpose(" in src
                         else "forward")
                key = (kind, ", ".join(_layoutless(comp.types.get(a, "?"))
                                       for a in ins.args),
                       _layoutless(ins.type_str),
                       f"loops {'x'.join(loops) or '-'}, {phase} "
                       f"{src.split('/')[-1]}")
                out[key] = out.get(key, 0) + mult
            if ins.opcode == "while":
                cond = ha._attr_comp(ins.attrs, "condition")
                trip = max(trips.get(cond[0], 1), 1) if cond else 1
                for b in ha._attr_comp(ins.attrs, "body"):
                    walk(b, mult * trip, loops + [str(trip)])
            elif ins.opcode in ("call", "async-start", "conditional"):
                for key in ("to_apply", "calls", "branch_computations",
                            "true_computation", "false_computation"):
                    for c in ha._attr_comp(ins.attrs, key):
                        walk(c, mult, loops)

    walk(entry, 1, [])
    return out


def port_collectives(arch: str, shape: str, mesh: str):
    """({(kind, operand shapes, result shapes): calls} of rank 0's op log
    of the port's sharded dry run of this smoke combination, its record)
    (a subprocess: ``python -m repro_torch.launch.dryrun --smoke``)."""
    import subprocess
    import tempfile

    from repro_torch.launch import op_analysis as oa

    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
             "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", tmp,
             "--trace-dir", tmp], check=True, stdout=subprocess.DEVNULL,
            env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"})
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)
                   if f.endswith(".ops.z")]
        log, _ = oa.load_log(path)
        with open(path.replace(".ops.z", ".json")) as f:
            rec = json.load(f)
    out = {}
    for r in log:
        ns, name = r["op"].split(".", 1)
        if ns == "_c10d_functional" and name in oa._COLLECTIVE_OPS:
            key = (oa._COLLECTIVE_OPS[name],
                   ", ".join(f"{d}{s}" for d, s in r["in"]),
                   ", ".join(f"{d}{s}" for d, s in r["out"]))
            out[key] = out.get(key, 0) + 1
    return out, rec


def _bytes_bf16eq(types: str) -> int:
    """bf16-equivalent bytes of an HLO result type or of a port result
    list ("bfloat16[2, 64]", ...)."""
    from repro.launch import hlo_analysis as ha

    names = {"bfloat16": "bf16", "float64": "f64", "float32": "f32",
             "float16": "f16", "int64": "s64", "int32": "s32",
             "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred"}
    types = re.sub(r"\b(" + "|".join(names) + r")\[",
                   lambda m: names[m.group(1)] + "[", types)
    return ha.type_bytes(types.replace(" ", ""), f32_as=2)


def print_collectives(combo, text: str, ref_rec: dict) -> None:
    """The reference's collectives of one combination beside the
    port's, each side's rows by kind then bytes, and each side's total
    beside its record's."""
    arch, shape, multi_pod = combo
    port, port_rec = port_collectives(arch, shape,
                                      "multi" if multi_pod else "single")
    for side, rows, rec in (("reference", hlo_collectives(text), ref_rec),
                            ("port", port, port_rec)):
        total = {}
        print(f"== {arch} x {shape} x {'multi' if multi_pod else 'single'}"
              f": {side} (kind, operands -> result, calls, bf16-eq. bytes"
              + (", where)" if side == "reference" else ")"))
        for key, n in sorted(rows.items(), key=lambda kv: (
                kv[0][0], -kv[1] * _bytes_bf16eq(kv[0][2]))):
            b = n * _bytes_bf16eq(key[2])
            c, t = total.get(key[0], (0, 0))
            total[key[0]] = (c + n, t + b)
            print(f"  {key[0]:18s} {key[1]} -> {key[2]}  x{n:g}  {b:.4e}"
                  + (f"  {key[3]}" if side == "reference" else ""))
        for kind, (c, t) in total.items():
            print(f"  {side} {kind}: {c:g} calls, {t:.4e} bytes")
        print(f"  {side} total: {sum(t for _, t in total.values()):.4e} "
              f"bytes (its record: {rec['collective_bytes_bf16eq']:.4e})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs on a (2, 2) / (2, 2, 2) mesh")
    ap.add_argument("--combo", action="append", default=[],
                    help="arch:shape:single|multi (repeatable; --smoke "
                         "without one: chip_smoke.py's DRYRUN_SMOKE_FLOPS_REL)")
    ap.add_argument("--collectives", action="store_true",
                    help="list each combination's collectives, the "
                         "reference's beside the port's")
    ap.add_argument("--json", default="", help="write the records here")
    args = ap.parse_args()
    if args.smoke:
        if args.combo:
            names = [tuple(c.split(":")) for c in args.combo]
        else:
            sys.path.insert(0, str(ROOT))
            import chip_smoke

            names = list(chip_smoke.DRYRUN_SMOKE_FLOPS_REL)
        combos = [(a, s, m == "multi") for a, s, m in names]
    else:
        combos = [("olmo-1b", "train_4k", False)]
    hlo = {} if args.collectives else None
    recs = run(combos, args.smoke, hlo)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(recs, f, indent=1)
    if args.collectives:
        for combo, rec in zip(combos, recs):
            print_collectives(combo, hlo[combo], rec)
    elif args.smoke:
        print("JAX_DRYRUN_SMOKE = {")
        for (a, s, mp), r in zip(combos, recs):
            print(f"    ({a!r}, {s!r}, {'multi' if mp else 'single'!r}): {{")
            for k in KEYS:
                print(f"        {k!r}: {r[k]!r},")
            print("    },")
        print("}")
    else:
        r = recs[0]
        print("JAX_DRYRUN = {")
        print(f"    'combination': ({r['arch']!r}, {r['shape']!r}, "
              f"{r['mesh']!r}),")
        for k in KEYS:
            print(f"    {k!r}: {r[k]!r},")
        print("}")


if __name__ == "__main__":
    main()
