"""The port's dry run against the JAX package's accounting on the CPU.

FLOPs on one device: the port's counted step (``dryrun.count`` with no
mesh: the plain kernel versions on fake tensors) against the reference's
loop-aware HLO count of the same step (``repro.train.step``'s prefill,
decode and train steps compiled as ``tests/test_hlo_dryrun.py::_hlo``
does; ``repro.launch.dryrun`` is not imported, it sets ``XLA_FLAGS``).
The tolerance is 0 where the formulations agree (dense, MoE and audio
prefill and decode) and 2% elsewhere, each difference with its cause:

  * train of an attention stack: the reference differentiates a scan
    whose body is the same for every layer, so its backward also runs
    layer 0's input gradient and its K gradient, which no LoRA leaf needs
    (layer 0's input is the frozen embedding); autograd over the port's
    layer loop skips both. The test adds those products to the port's
    count, and then the counts agree exactly.
  * Mamba2 (ssm, hybrid), every mode: the reference's three-operand
    einsums fold the decay factor into a product XLA counts as a dot; the
    port multiplies it elementwise. Within 2%.

The sharded dry run runs as ``python -m repro_torch.launch.dryrun
--smoke`` in subprocesses with ``tests/test_hlo_dryrun.py``'s assertions.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jsmoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.hlo_analysis import analyze
from repro.launch.specs import input_specs as jinput_specs
from repro.models import transformer as jtf
from repro.sharding import split_params
from repro.train import step as jstep
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline

SRC = str(Path(__file__).resolve().parents[1] / "src")
BATCH, SEQ = 2, 64
EXACT_FAMILIES = ("dense", "moe", "audio")


def _ref_dot_flops(arch: str, mode: str) -> float:
    cfg = jsmoke(arch)
    shape = JShapeConfig("t", SEQ, BATCH, mode)
    values = split_params(jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), cfg)))[0]
    batch, cache = jinput_specs(cfg, shape)
    if mode == "train":
        step = jstep.make_train_step(cfg, JTrainConfig(
            remat="full", seq_len=SEQ, global_batch=BATCH, microbatches=1))
        args = (values, jax.eval_shape(jstep.init_opt_state, values), batch)
    elif mode == "prefill":
        step = ((lambda p, b: jtf.forward(cfg, p, b)[0]) if cfg.encoder_only
                else jstep.make_prefill_step(cfg, SEQ))
        args = (values, batch)
    else:
        step = jstep.make_decode_step(cfg)
        args = (values, cache, batch)
    text = jax.jit(step).lower(*args).compile().as_text()
    return analyze(text)["dot_flops"]


def _layer0_grads(cfg) -> float:
    """The products of an attention stack's layer 0 that only the
    reference runs in its backward: the input gradient through the q, k
    and v projections (and the adapters' A), and the gradient of K (no
    LoRA leaf feeds layer 0's K, whose input is the frozen embedding)."""
    t, d, r = BATCH * SEQ, cfg.d_model, cfg.lora.rank
    outs = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    adapted = sum(x in cfg.lora.targets for x in ("q", "k", "v"))
    d_k = 2.0 * BATCH * cfg.num_heads * SEQ * SEQ * cfg.head_dim
    return 2.0 * t * d * outs + 2.0 * t * r * d * adapted + d_k


CASES = [(a, m) for a in ("llama2-7b", "mamba2-370m", "zamba2-2.7b",
                          "mixtral-8x7b", "hubert-xlarge")
         for m in ("prefill", "decode", "train")
         if not (a == "hubert-xlarge" and m == "decode")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_one_device_dot_flops_match_reference_hlo(arch, mode):
    cfg = get_smoke_config(arch)
    got = dryrun.count(cfg, ShapeConfig("t", SEQ, BATCH, mode),
                       microbatches=1)
    want = _ref_dot_flops(arch, mode)
    flops = got["dot_flops"]
    if cfg.arch_type in EXACT_FAMILIES:
        if mode == "train":
            flops += _layer0_grads(cfg)
        assert flops == want
    else:
        assert flops == pytest.approx(want, rel=0.02)
    assert got["memory"]["peak_size_in_bytes"] >= \
        got["memory"]["argument_size_in_bytes"] > 0


def _dryrun(args, out):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         *args, "--out", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_subprocess_smoke_dryruns(tmp_path):
    """The reference test's two combinations, run side by side (each
    mixtral mesh in its own process): mixtral train_4k on (2, 2) and
    (2, 2, 2), and hubert-xlarge on every shape on (2, 2) (train and prefill counted, both decode shapes skipped). The
    sharded per-device FLOPs times the device count are at least the one
    device's: sharding splits the work, it does not remove any."""
    out1, out2 = str(tmp_path / "moe"), str(tmp_path / "audio")
    procs = [_dryrun(["--arch", "mixtral-8x7b", "--shape", "train_4k",
                      "--mesh", mesh], out1) for mesh in ("single", "multi")]
    procs.append(_dryrun(["--arch", "hubert-xlarge", "--shape", "all",
                          "--mesh", "single", "--trace-dir",
                          str(tmp_path / "ops")], out2))
    for p in procs:
        stdout, stderr = p.communicate(timeout=420)
        assert p.returncode == 0, stdout + stderr
    recs = [json.load(open(os.path.join(out1, f)))
            for f in sorted(os.listdir(out1))]
    assert [r["mesh"] for r in recs] == ["2x2", "2x2x2"]
    one = dryrun.count(get_smoke_config("mixtral-8x7b"),
                       ShapeConfig(*dryrun._SMOKE_SHAPES["train_4k"]))
    for r in recs:
        assert r["status"] == "ok", r
        assert r["flops_per_device"] > 0
        assert r["collective_bytes"] > 0
        assert r["while_trips"], r
        assert r["kernels"] == "plain"
        assert r["flops_per_device"] * r["devices"] >= one["dot_flops"]
    by_shape = {r["shape"]: r for r in (json.load(open(os.path.join(out2, f)))
                                        for f in os.listdir(out2))}
    assert by_shape["train_4k"]["status"] == "ok"
    assert by_shape["prefill_32k"]["status"] == "ok"
    assert by_shape["decode_32k"]["status"] == "skipped"   # encoder-only
    assert by_shape["long_500k"]["status"] == "skipped"
    # the roofline reads the records; reanalyze counts the logs again
    row = roofline.analyze_record(by_shape["train_4k"])
    assert row["step_bound_s"] == max(row["compute_s"], row["memory_s"],
                                      row["collective_s"]) > 0
    env = dict(os.environ, PYTHONPATH=SRC)
    before = dict(by_shape["train_4k"])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.reanalyze",
         "--trace-dir", str(tmp_path / "ops"), "--dryrun-dir", out2],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "re-analyzed 2 records" in proc.stdout
    after = json.load(open(os.path.join(out2,
                                        "hubert-xlarge_train_4k_2x2.json")))
    assert after == before
