"""Small stand-ins of the benchmark's cells for its CPU tests: a Mixtral-
style and a Mamba-2 configuration a few layers deep and 64 wide, in f32, a
short lora_train traffic mix, limits set at that size, and a catalog
directory holding them."""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from port_bench import catalog

MOE = {"name": "tiny-moe", "arch_type": "moe", "num_layers": 2,
       "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
       "d_ff": 96, "vocab_size": 256, "rope_theta": 10000.0,
       "sliding_window": None, "causal": True, "norm_type": "rmsnorm",
       "norm_eps": 1e-5, "mlp_act": "silu", "tie_embeddings": False,
       "moe": {"num_experts": 4, "top_k": 2, "capacity_factor": 1.25,
               "aux_loss_coef": 0.001},
       "lora": {"rank": 4, "alpha": 8.0, "targets": ["q", "v"]},
       "dtype": "float32"}
SSM = {"name": "tiny-ssm", "arch_type": "ssm", "num_layers": 2,
       "d_model": 64, "num_heads": 0, "num_kv_heads": 0, "head_dim": 1,
       "d_ff": 0, "vocab_size": 256, "norm_type": "rmsnorm",
       "norm_eps": 1e-5, "tie_embeddings": True,
       "ssm": {"state_size": 16, "head_dim": 16, "expand": 2, "n_groups": 1,
               "conv_width": 4, "chunk_size": 32},
       "lora": {"rank": 4, "alpha": 8.0, "targets": ["q", "v"]},
       "dtype": "float32"}
# each stand-in borrows a real cell's traffic kind and optimizer
CELLS = {"tiny.moe": (MOE, "lora.b8s1k"), "tiny.ssm": (SSM, "lora.b24s2k")}
# The stand-ins' limits, set as the cells' are at their size (traffic(),
# the port's plain path in f32): lower = the largest of 12 seeds' sound
# runs (3e9 + 7919 i), upper = the least of 3 seeds' control (the
# reference in fp8), limit = lower + 0.6 (upper - lower).
# tiny.moe lower: loss 1.900e-07, grad_norm 1.715e-07, first_grad
# 1.702e-07, change 1.233e-05, route_gap 0; control: 2.769e-03, 1.558e-02,
# 4.035e-02, 2.740e-02, 1.711e-02. tiny.ssm lower: 1.721e-07, 1.164e-07,
# 1.295e-07, 1.397e-05; control: 8.240e-05, 1.015e-02, 1.247e-02,
# 7.311e-03.
LIMITS = {"tiny.moe": {"loss": 1.66e-03, "grad_norm": 9.35e-03,
                       "first_grad": 2.42e-02, "change": 1.64e-02,
                       "route_gap": 1.03e-02},
          "tiny.ssm": {"loss": 4.95e-05, "grad_norm": 6.09e-03,
                       "first_grad": 7.48e-03, "change": 4.39e-03}}


def traffic(real: str, batch: int = 2, seq_len: int = 64) -> dict:
    t = catalog.traffic(real)
    t.update(name=f"tiny.{real}", batch=batch, seq_len=seq_len,
             trace_steps=2)
    return t


def make_catalog(root: Path, metrics=("mfu.train", "idle_pct.train")):
    """Writes the stand-ins' configurations, traffic, cells and the named
    metrics' readers under ``root``; returns a BENCHMARK.json dict of
    them."""
    root = Path(root)
    for kind in ("configs", "traffic", "cells", "metrics"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    bench = json.loads((catalog.ROOT.parent / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"], bench["workloads"] = [], []
    for name, (model, real_traffic) in CELLS.items():
        (root / "configs" / f"{model['name']}.json").write_text(
            json.dumps({"name": model["name"], "model": model}))
        t = traffic(real_traffic)
        (root / "traffic" / f"{t['name']}.json").write_text(json.dumps(t))
        (root / "cells" / f"{name}.json").write_text(
            json.dumps({"limits": LIMITS[name]}))
        bench["configs"].append({"name": model["name"]})
        bench["workloads"].append({"name": name, "config": model["name"],
                                   "traffic": t["name"], "chips": 1})
    for m in metrics:
        shutil.copy(catalog.ROOT / "metrics" / f"{m}.py",
                    root / "metrics" / f"{m}.py")
    bench["per_layer"] = [dict(m, workloads=list(CELLS))
                          for m in bench["per_layer"] if m["name"] in metrics]
    return bench


_RUN = """
import json, sys, tempfile
opened = set()
sys.addaudithook(lambda ev, args: opened.add(str(args[0]))
                 if ev == "open" and isinstance(args[0], str) else None)
from port_bench import faults, run, testing
root = tempfile.mkdtemp()
bench = testing.make_catalog(root)
wrap = faults.FAULTS[sys.argv[3]] if sys.argv[3] else (lambda step: step)
rc = run.main(["--workload", sys.argv[1], "--seed", sys.argv[2],
               "--seconds", "0.1", "--trace", "0"], bench=bench, root=root,
              device="cpu", step_wrapper=wrap)
print(json.dumps({"rc": rc, "opened": sorted(opened),
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def run_fresh(workload: str, seed: int, fault: str = "") -> tuple:
    """One run of a stand-in cell on the CPU in a fresh interpreter (the
    run refuses a process that holds JAX or the JAX package, as a test
    process may), with ``fault`` (a name of ``faults.FAULTS``) under the
    step. Returns (the result's line, {"rc", "opened", "top"})."""
    root = catalog.ROOT.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", _RUN, workload, str(seed),
                          fault], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600, check=True)
    lines = out.stdout.strip().splitlines()
    info = json.loads(lines[-1])
    result = json.loads(lines[-2]) if info["rc"] == 0 else None
    return result, info
