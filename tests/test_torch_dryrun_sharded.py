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
    that only the reference runs are added to the port's (``_layer0_grads``,
    as ``tests/test_torch_dryrun.py`` adds them, reckoned on this rank's
    block: its tokens, heads and width); within 2% for Mamba2 (ssm and
    hybrid), whose three-operand einsums the reference counts as dots where
    the port multiplies elementwise. Each combination's tolerance is in
    ``COMBOS``.
  * collective bytes, bf16-equivalent on both sides (XLA's CPU HLO widens
    bf16 to f32): at most ``COLLECTIVE_BOUND`` times the reference's, except
    where ``COLLECTIVE_EXCEPTIONS`` names the combination with its cause.
  * traffic is reported beside the reference's (``-s``), not held: the
    port counts every unfused op's operands, XLA its fusions'.
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
}
COLLECTIVE_BOUND = 1.25
# combination -> (bound, cause)
COLLECTIVE_EXCEPTIONS = {
    ("zamba2-2.7b", "train_4k", "single"): (
        1.5, "1.45x: the all-gathers are 3.44e7 bytes in 493 calls against "
             "the reference's 1.80e7 in 261 (all-reduces 7.2e6 against "
             "8.6e6). The eager step gathers a weight's fsdp block at each "
             "product that reads it: a Mamba2 layer's wz, wx and out_proj "
             "in its recompute and again for its input gradient, the "
             "shared attention block's at each of its super-blocks, where "
             "the partitioned program gathers fewer times."),
}
# the reference's processes (each runs its combinations in turn)
REF_GROUPS = 3


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
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
             "--arch", arch, "--shape", shape, "--mesh", mesh, "--out",
             str(out)], env=_env(), stdout=subprocess.PIPE,
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
    at once, and "full": the reference's full-size record
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
        ports[combo] = json.loads(f.read_text())
    return {**{c: (refs[c], ports[c]) for c in COMBOS},
            "full": json.loads(full[0].read_text())[0]}


def _layer0_grads(cfg, shape_name: str, mesh: str) -> float:
    """``chip_smoke.layer0_grads`` on this combination: the products of an
    attention stack's layer 0 that only the reference's backward runs, on
    this rank's tokens (one sequence a microbatch) and block of heads."""
    _, seq, batch, mode = dryrun._SMOKE_SHAPES[shape_name]
    if mode != "train" or cfg.arch_type not in ("dense", "moe", "vlm",
                                                "audio"):
        return 0.0
    batch_shards = 4 if mesh == "multi" else 2   # ("pod",) "data"
    return chip_smoke.layer0_grads(cfg, seq, batch // batch_shards, 2)


@pytest.mark.parametrize("combo", list(COMBOS), ids="-".join)
def test_sharded_dot_flops_match_the_partitioned_reference(records, combo):
    ref, port = records[combo]
    assert ref["status"] == port["status"] == "ok", (ref, port)
    flops = port["flops_per_device"] + _layer0_grads(
        get_smoke_config(combo[0]), combo[1], combo[2])
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
    bound = COLLECTIVE_EXCEPTIONS.get(combo, (COLLECTIVE_BOUND, ""))[0]
    print(f"{'-'.join(combo)}: collectives "
          f"{port['collective_bytes_bf16eq']:.4e} against "
          f"{ref['collective_bytes_bf16eq']:.4e} (bf16-eq.): {ratio:.3f}x")
    assert 0 < ratio <= bound


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
ONE_DEVICE = {
    ("llama2-7b", "train", False): [
        1050673152.0, 120915710.0, 0.0, 9924368, 6690308, {}],
    ("llama2-7b", "train", True): [
        1032388608.0, 106358526.0, 0.0, 9776912, 6690308,
        {"lora_matmul": 10, "flash_attention": 4,
         "flash_attention_backward": 2}],
    ("mamba2-370m", "prefill", False): [
        237764608.0, 62498992.0, 0.0, 8332224, 3994752, {}],
    ("mamba2-370m", "prefill", True): [
        246415360.0, 35290288.0, 0.0, 6987968, 3994752,
        {"lora_matmul": 4, "ssd_scan": 2}],
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
