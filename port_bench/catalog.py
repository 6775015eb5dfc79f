"""Finds what a cell is made of by name, each in a file of its own:

- a configuration: ``configs/<name>.json``;
- a traffic mix: ``traffic/<name>.json``, whose ``kind`` names the driver
  that runs it, ``drivers/<kind>.py``;
- a cell's limits for ``correct``: ``cells/<workload>.json``;
- a per-layer metric: ``metrics/<name>.py``, with ``UNIT``, ``LAYER``,
  ``MOVES`` and ``read(summary)``, which returns None where it finds
  nothing to read;
- a configuration family's plain reference: ``reference/<arch_type>.py``.

A later cell or metric is a new file here and an entry in BENCHMARK.json;
no file that is there changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(root, kind: str, name: str) -> dict:
    return json.loads((Path(root) / kind / f"{name}.json").read_text())


def config(name: str, root=ROOT) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root=ROOT) -> dict:
    return _json(root, "traffic", name)


def cell(name: str, root=ROOT) -> dict:
    return _json(root, "cells", name)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root=ROOT):
    return _module(Path(root) / "metrics" / f"{name}.py",
                   f"port_bench_metric_{name.replace('.', '_')}")


def driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")


def reference(arch_type: str):
    return importlib.import_module(f"port_bench.reference.{arch_type}")
