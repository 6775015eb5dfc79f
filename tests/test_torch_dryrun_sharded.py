"""The port's sharded dry run against the reference's partitioned program,
per device, on the smoke configs and meshes.

Each side counts in subprocesses of its own, all started together: the
reference by ``tools/jax_dryrun_refs.py --smoke`` (``repro.launch.dryrun.
run_one`` on 8 host devices, its mesh made with Auto axes: the dots and
collectives of XLA's SPMD-partitioned HLO, ``hlo_analysis.analyze``), the
port by ``python -m repro_torch.launch.dryrun --smoke`` (DTensors over a
``fake`` group, the op log of rank 0). The main process sets no
``XLA_FLAGS``. Held per combination:

  * dot FLOPs: equal to the reference's, once layer 0's backward products
    that only the reference runs are added to the port's
    (``chip_smoke.smoke_layer0_grads``, as ``tests/test_torch_dryrun.py``
    adds them, reckoned on this rank's
    block: its tokens, heads and width); within 2% for Mamba2 (ssm and
    hybrid), whose three-operand einsums the reference counts as dots where
    the port multiplies elementwise. Each combination's tolerance is in
    ``COMBOS``.
  * collective bytes, bf16-equivalent on both sides (XLA's CPU HLO widens
    bf16 to f32): between ``COLLECTIVE_FLOOR`` and ``COLLECTIVE_BOUND``
    times the reference's (the floor so that a kept gather cannot hide a
    collective the reference runs).
  * plain placements: the port's step runs under a hook on DTensor's
    sharding propagation (``_PORT``), and no op takes or gives a strided
    split (``_StridedShard``, which PyTorch 2.11 cannot propagate through
    a view) or pads a split tensor on a mesh of more than one dimension
    (PyTorch 2.11's ``constant_pad_nd`` strategy is written for one).
    Either fails the card machine's run of the combination.
  * traffic is reported beside the reference's (``-s``), not held: the
    port counts every unfused op's operands, XLA its fusions'.

``chip_smoke.JAX_DRYRUN_SMOKE``, which ``[dryrun]`` holds the port's smoke
combinations to on the card's machine (no JAX there), is what the
reference counts now, and ``chip_smoke.DRYRUN_SMOKE_FLOPS_REL`` is
``COMBOS``.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, op_analysis, stand_ins

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TIMEOUT = 420

# (arch, shape, mesh): relative FLOPs tolerance
COMBOS = {
    ("olmo-1b", "train_4k", "single"): 0.0,
    ("olmo-1b", "train_4k", "multi"): 0.0,
    ("zamba2-2.7b", "train_4k", "single"): 0.02,
    ("mamba2-370m", "prefill_32k", "single"): 0.02,
    ("qwen2-vl-7b", "train_4k", "single"): 0.0,
    ("mixtral-8x7b", "train_4k", "single"): 0.0,
    ("hubert-xlarge", "prefill_32k", "single"): 0.0,
    ("llama2-7b", "decode_32k", "single"): 0.0,
    ("zamba2-2.7b", "decode_32k", "single"): 0.02,
}
COLLECTIVE_FLOOR, COLLECTIVE_BOUND = 0.8, 1.25
# the reference's processes (each runs its combinations in turn)
REF_GROUPS = 3

# The port's dry run (``python -m repro_torch.launch.dryrun`` and its
# arguments) under a hook on DTensor's sharding propagation; argv[1] names
# the JSON file that gets every op whose propagation took or gave a
# strided split, or that padded a split tensor on a mesh of more than one
# dimension. The hook only reads the specs: the counts are the CLI's.
_PORT = r'''
import json, runpy, sys

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._dtensor_spec import DTensorSpec
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._pytree import tree_leaves

out, sys.argv = sys.argv[1], ["dryrun"] + sys.argv[2:]
ONE_DIM = {torch.ops.aten.constant_pad_nd.default}
found = set()


def specs(x):
    return [s for s in tree_leaves(
        x, is_leaf=lambda v: isinstance(v, DTensorSpec))
        if isinstance(s, DTensorSpec)]


def hooked(propagate):
    def call(schema, *args, **kwargs):
        result = propagate(schema, *args, **kwargs)
        ins = specs((schema.args_schema, schema.kwargs_schema))
        if result.redistribute_schema is not None:
            ins += specs(result.redistribute_schema.args_schema)
        strided = [str(s) for s in ins + specs(result.output_spec)
                   if any(isinstance(p, _StridedShard) for p in s.placements)]
        if strided:
            found.add(f"{schema.op}: strided {strided[0]}")
        if schema.op in ONE_DIM and any(
                s.mesh.ndim > 1 and not all(p.is_replicate()
                                            for p in s.placements)
                for s in ins):
            found.add(f"{schema.op} of a split input on a "
                      f"{ins[0].mesh.ndim}-D mesh")
        return result
    return call


prop = DTensor._op_dispatcher.sharding_propagator
for name in ("propagate_op_sharding", "propagate_op_sharding_non_cached"):
    setattr(prop, name, hooked(getattr(prop, name)))
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
finally:
    with open(out, "w") as f:
        json.dump(sorted(found), f)
'''


def _env():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    return env


def _ref_procs(tmp):
    combos = list(COMBOS)
    procs = []
    for g in range(REF_GROUPS):
        out = tmp / f"ref{g}.json"
        args = [a for arch, shape, mesh in combos[g::REF_GROUPS]
                for a in ("--combo", f"{arch}:{shape}:{mesh}")]
        procs.append((out, subprocess.Popen(
            [sys.executable, str(ROOT / "tools" / "jax_dryrun_refs.py"),
             "--smoke", *args, "--json", str(out)], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def _port_procs(tmp):
    procs = []
    for arch, shape, mesh in COMBOS:
        out = tmp / f"port_{arch}_{shape}_{mesh}"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", _PORT, str(out) + ".placements.json",
             "--smoke", "--arch", arch, "--shape", shape, "--mesh", mesh,
             "--out", str(out)], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _full_ref_proc(tmp):
    out = tmp / "full.json"
    return out, subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "jax_dryrun_refs.py"),
         "--json", str(out)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{combination: (reference record, port record)}, both sides counted
    at once (the port's record with "placements": the ops its hook found),
    and "full": the reference's full-size record
    (``chip_smoke.JAX_DRYRUN``'s)."""
    tmp = tmp_path_factory.mktemp("dryrun_sharded")
    full = _full_ref_proc(tmp)
    ref, port = _ref_procs(tmp), _port_procs(tmp)
    for _, p in [full] + ref + port:
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for _, q in [full] + ref + port:
                q.kill()
            raise
        assert p.returncode == 0, stdout[-3000:] + stderr[-3000:]
    refs = {}
    for out, _ in ref:
        for r in json.loads(out.read_text()):
            mesh = "multi" if r["mesh"] == "2x2x2" else "single"
            refs[(r["arch"], r["shape"], mesh)] = r
    ports = {}
    for (out, _), combo in zip(port, COMBOS):
        (f,) = out.glob("*.json")
        ports[combo] = {**json.loads(f.read_text()), "placements": json.loads(
            Path(str(out) + ".placements.json").read_text())}
    return {**{c: (refs[c], ports[c]) for c in COMBOS},
            "full": json.loads(full[0].read_text())[0]}


@pytest.mark.parametrize("combo", list(COMBOS), ids="-".join)
def test_sharded_dot_flops_match_the_partitioned_reference(records, combo):
    ref, port = records[combo]
    assert ref["status"] == port["status"] == "ok", (ref, port)
    flops = port["flops_per_device"] + chip_smoke.smoke_layer0_grads(*combo)
    print(f"{'-'.join(combo)}: FLOPs {flops:.6e} against "
          f"{ref['flops_per_device']:.6e}, traffic "
          f"{port['bytes_per_device_bf16eq']:.4e} against "
          f"{ref['bytes_per_device_bf16eq']:.4e} (bf16-eq.)")
    assert flops == pytest.approx(ref["flops_per_device"],
                                  rel=COMBOS[combo])


@pytest.mark.parametrize("combo", list(COMBOS), ids="-".join)
def test_sharded_collective_bytes_within_bound(records, combo):
    ref, port = records[combo]
    ratio = port["collective_bytes_bf16eq"] / ref["collective_bytes_bf16eq"]
    print(f"{'-'.join(combo)}: collectives "
          f"{port['collective_bytes_bf16eq']:.4e} against "
          f"{ref['collective_bytes_bf16eq']:.4e} (bf16-eq.): {ratio:.3f}x")
    assert COLLECTIVE_FLOOR <= ratio <= COLLECTIVE_BOUND


@pytest.mark.parametrize("combo", list(COMBOS), ids="-".join)
def test_sharded_step_keeps_plain_placements(records, combo):
    """No DTensor op of the step takes or gives a placement that PyTorch
    2.11 cannot propagate or redistribute (``_PORT``'s hook)."""
    port = records[combo][1]
    assert port["status"] == "ok", port
    assert port["placements"] == []


def test_smoke_references_are_chip_smokes(records):
    """``chip_smoke.JAX_DRYRUN_SMOKE``, which ``[dryrun]`` holds each
    smoke combination's record to on the card's machine, is what
    ``tools/jax_dryrun_refs.py --smoke`` counts now, for the combinations
    and FLOPs tolerances of ``COMBOS``."""
    assert chip_smoke.DRYRUN_SMOKE_FLOPS_REL == COMBOS
    assert set(chip_smoke.JAX_DRYRUN_SMOKE) == set(COMBOS)
    for combo in COMBOS:
        rec, want = records[combo][0], chip_smoke.JAX_DRYRUN_SMOKE[combo]
        assert {k: rec[k] for k in want} == want, combo


def test_full_size_reference_is_chip_smokes(records):
    """``chip_smoke.JAX_DRYRUN``, which ``[dryrun]`` holds the port's
    olmo-1b train_4k (16, 16) record to on the card's machine (no JAX
    there), is what ``tools/jax_dryrun_refs.py`` counts now."""
    rec = records["full"]
    want = chip_smoke.JAX_DRYRUN
    assert (rec["arch"], rec["shape"], rec["mesh"]) == want["combination"]
    assert {k: rec[k] for k in want if k != "combination"} == {
        k: v for k, v in want.items() if k != "combination"}


# the one-device dry run's records (dot FLOPs, traffic, collective bytes,
# peak and argument bytes, kernel launches) for (arch, mode, kernels) at
# batch 2 x 64 tokens: the sharded layout rules leave them as they were
# (mamba2-370m's prefill: its conv state cut from the last frames of x, B
# and C, not from their whole cat, and on the card's path the conv's
# kernel in place of the cat and the chain of torch ops)
ONE_DEVICE = {
    ("llama2-7b", "train", False): [
        1050673152.0, 120915710.0, 0.0, 9924368, 6690308, {}],
    ("llama2-7b", "train", True): [
        1032388608.0, 106358526.0, 0.0, 9776912, 6690308,
        {"lora_matmul": 10, "flash_attention": 4,
         "flash_attention_backward": 2}],
    ("mamba2-370m", "prefill", False): [
        237764608.0, 62551216.0, 0.0, 7788224, 3994752, {}],
    ("mamba2-370m", "prefill", True): [
        246415360.0, 22504112.0, 0.0, 6443968, 3994752,
        {"lora_matmul": 4, "causal_conv": 2, "ssd_scan": 2}],
    ("mixtral-8x7b", "decode", False): [
        27648000.0, 17462064.0, 0.0, 15740124, 15594504, {}],
    ("mixtral-8x7b", "decode", True): [
        27648000.0, 17415984.0, 0.0, 15740124, 15594504,
        {"lora_matmul": 4}],
}


@pytest.mark.parametrize("case", list(ONE_DEVICE),
                         ids=lambda c: "-".join(
                             (c[0], c[1], "kernels" if c[2] else "plain")))
def test_one_device_records_unchanged(case):
    arch, mode, kernels = case
    r = dryrun.count(get_smoke_config(arch), ShapeConfig("t", 64, 2, mode),
                     microbatches=1, kernels=kernels)
    got = [r["dot_flops"], r["traffic_bytes"], r["collective_bytes_total"],
           r["memory"]["peak_size_in_bytes"],
           r["memory"]["argument_size_in_bytes"],
           {n: v["count"] for n, v in r["kernels"].items()}]
    assert got == ONE_DEVICE[case]


def test_layout_rules_leave_plain_ops_alone():
    """The stand-ins' products and reductions act on DTensors only: an
    unsharded training step logs the same ops, shapes and FLOPs with them
    installed as without."""
    cfg = get_smoke_config("llama2-7b")
    step, args, _ = dryrun.build_step(cfg, ShapeConfig("t", 32, 2, "train"),
                                      None, microbatches=2)

    def log(ctx):
        with ctx, op_analysis.count_ops(args) as counter:
            step(*args)
        return counter.log

    plain = log(contextlib.nullcontext())
    within = log(stand_ins.installed())
    assert within == plain and any(r["flops"] for r in plain)
