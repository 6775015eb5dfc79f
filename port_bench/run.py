"""Runs one cell of BENCHMARK.json once and prints its result.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's number of CUDA
cards. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number ``correct`` compared,
with its limit. The same numbers end standard error. Build and kernel
caches stay inside the checkout, under ``build/``.

The program is the port, ``repro_torch`` under ``src/``. A run that finds
no card, fewer cards than the cell asks for, or, once the window has
closed, any of ``FORBIDDEN`` among the loaded modules' top-level names,
prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Fixed cache directories inside the checkout, for anything the run
    compiles (the port builds its kernels into build/repro_torch itself)."""
    build = ROOT / "build" / "port_bench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def resolve(bench: dict, workload: str, root) -> SimpleNamespace:
    """A workload's entry, configuration, traffic, limits and the readers
    of the per-layer metrics it reports."""
    from port_bench import catalog

    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    per_layer = {m["name"]: catalog.metric(m["name"], root)
                 for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])}
    traffic = catalog.traffic(cell["traffic"], root)
    return SimpleNamespace(
        entry=cell, model=catalog.config(conf["name"], root)["model"],
        traffic=traffic, cell=catalog.cell(workload, root),
        per_layer=per_layer, driver=catalog.driver(traffic["kind"]))


def main(argv=None, *, bench=None, root=None, device="cuda",
         step_wrapper=lambda step: step) -> int:
    from port_bench import catalog

    args = _args(argv)
    _cache_dirs()
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    ctx = resolve(bench, args.workload, root or catalog.ROOT)
    import torch

    if device == "cuda":
        chips = ctx.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"port_bench: the cell needs {chips} CUDA card(s); found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    ctx.__dict__.update(seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), device=device, start=START,
                        step_wrapper=step_wrapper)
    out = ctx.driver.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    dev = out.pop("device")
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": ctx.entry["chips"], **dev}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, **dev}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {name: {"value": v, "unit": units[name]}
               for name, v in out.pop("metrics").items() if v is not None}
    checks = out.pop("checks")
    result = {"correct": out.pop("correct"), "attempted": out.pop("attempted"),
              "failed": out.pop("failed"), "metrics": metrics, "device": dev,
              **out, "checks": checks}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
