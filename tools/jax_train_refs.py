"""Record the JAX package's results on chip_smoke.py's ``[train-ref]`` and
``[elastic]`` phases, which hold the PyTorch port to them on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_train_refs.py

- ``TRAIN_REF``: the reference's jitted ``make_train_step`` on the CPU, on
  the llama2-7b smoke config with the port's numpy weights
  (``repro_torch.convert.random_model_params``, numpy only) and
  ``chip_smoke.train_ref_batch``'s batches, built with the reference's
  ``ShardedLMLoader`` and ``make_mrope_positions``, for each of
  ``chip_smoke.TRAIN_REF_RUNS``:
  every step's loss, grad norm and lr, and the LoRA leaves' movement over
  the steps (sum of |after - before| and of its squares, in f64).
- ``TRAIN_SSM_REF``: the same for each of ``chip_smoke.TRAIN_SSM_ARCHS``
  (the mamba2-370m and zamba2-2.7b smoke configs), held by
  ``[train-ssm-ref]``.
- ``TRAIN_FAM_REF``: the same for each of ``chip_smoke.TRAIN_FAM_ARCHS``
  (the mixtral-8x7b, qwen2-vl-7b and hubert-xlarge smoke configs; the
  embedding families' batches with embeddings, targets, M-RoPE positions
  of an image span and a loss mask), held by ``[train-fam-ref]``.
- ``TRAIN_DENSE_REF``: the same for each arch of ``chip_smoke.DENSE_REFS``
  (the olmo-1b, granite-20b, qwen1.5-110b, command-r-plus-104b and
  mixtral-8x22b smoke configs), held by ``[train-dense-ref]``.
- ``DENSE_REFS``' tokens: the reference's ``ServingEngine`` on the same
  smoke configs with ``random_model_params(cfg, seed)``, greedy on
  ``chip_smoke.serve_ref_prompts(np, vocab, seed, prompt)`` for
  ``chip_smoke.SERVE_REF_NEW`` tokens, held by ``[serve-dense-ref]``.
- ``ELASTIC_REF``: the reference's ``ElasticTrainer`` on the full setting of
  examples/elastic_finetune.py (tiny-100m, AHAP(3, 1, 0.7), ARIMA on
  ``vast_like_trace(seed=4, days=2)``, the calibrated switching cost) with
  its train step stubbed: the plan does not depend on the losses. Per slot
  (t, n_od, n_spot, mu, steps), then total_steps, utility, cost and
  completion time.

Prints them as chip_smoke.py holds them, and the seconds each part took on
stderr.
"""
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import TrainConfig, get_config, get_smoke_config  # noqa: E402
from repro.configs.base import JobConfig  # noqa: E402
from repro.core.market import vast_like_trace  # noqa: E402
from repro.core.policies import AHAP, AHAPParams  # noqa: E402
from repro.core.predictor import ARIMAPredictor  # noqa: E402
from repro.data import ShardedLMLoader  # noqa: E402
from repro.models.frontends import make_mrope_positions  # noqa: E402
from repro.serve import Request, ServingEngine  # noqa: E402
from repro.train.elastic import ElasticTrainer  # noqa: E402
from repro.train.step import (TrainMetrics, init_opt_state,  # noqa: E402
                              make_train_step)
from repro.utils.partition import is_lora_path, partition_by_path  # noqa: E402
from repro_torch.convert import random_model_params  # noqa: E402

# the reference's core package re-exports a function under this name
calibrate = __import__("repro.core.throughput",
                       fromlist=["calibrate"]).calibrate


def _movement(before, after):
    d = [np.asarray(a, np.float64) - np.asarray(b, np.float64)
         for a, b in zip(after, before)]
    return (float(sum(np.abs(x).sum() for x in d)),
            float(sum(np.square(x).sum() for x in d)))


def train_ref(arch=chip_smoke.TRAIN_REF_ARCH):
    cfg = get_smoke_config(arch)
    out = {}
    for mb, kw in chip_smoke.TRAIN_REF_RUNS.items():
        tcfg = TrainConfig(**kw)
        params = jax.tree.map(jnp.asarray, random_model_params(
            cfg, chip_smoke.TRAIN_REF_SEED))
        opt = init_opt_state(params)
        step = jax.jit(make_train_step(cfg, tcfg))
        lora0 = partition_by_path(params, is_lora_path)[0]
        rows = {"loss": [], "grad_norm": [], "lr": []}
        for i in range(chip_smoke.TRAIN_REF_STEPS):
            params, opt, m = step(params, opt, chip_smoke.train_ref_batch(
                np, cfg, tcfg.global_batch, tcfg.seq_len, i,
                data=(ShardedLMLoader, make_mrope_positions)))
            for k in rows:
                rows[k].append(float(getattr(m, k)))
        move_abs, move_sq = _movement(
            lora0, partition_by_path(params, is_lora_path)[0])
        out[mb] = {**{k: tuple(v) for k, v in rows.items()},
                   "move_abs": move_abs, "move_sq": move_sq}
    return out


def train_ssm_ref():
    return {arch: train_ref(arch) for arch in chip_smoke.TRAIN_SSM_ARCHS}


def train_fam_ref():
    return {arch: train_ref(arch) for arch in chip_smoke.TRAIN_FAM_ARCHS}


def train_dense_ref():
    return {arch: train_ref(arch) for arch in chip_smoke.DENSE_REFS}


def dense_serve_ref():
    """arch -> DENSE_REFS' (seed, prompt, max_len, tokens)."""
    out = {}
    for arch, (seed, prompt, max_len, _) in chip_smoke.DENSE_REFS.items():
        cfg = get_smoke_config(arch)
        vals = jax.tree.map(jnp.asarray, random_model_params(cfg, seed))
        prompts = chip_smoke.serve_ref_prompts(np, cfg.vocab_size, seed,
                                               prompt)
        got = ServingEngine(cfg, vals, max_len=max_len).generate_batch(
            [Request(p, chip_smoke.SERVE_REF_NEW) for p in prompts])
        out[arch] = (seed, prompt, max_len,
                     tuple(tuple(int(t) for t in g) for g in got))
    return out


def _print_by_arch(name, refs):
    print(f"{name} = {{")
    for arch, runs in refs.items():
        print(f"    {arch!r}: {{")
        for mb, row in runs.items():
            print(f"        {mb}: {{")
            for k, v in row.items():
                print(f"            {k!r}: {v!r},")
            print("        },")
        print("    },")
    print("}")


def elastic_ref():
    cfg = get_config("tiny-100m")
    tcfg = TrainConfig(seq_len=128, global_batch=8, lr=1e-3, total_steps=400)
    job = JobConfig(workload=50, deadline=8, n_min=1, n_max=10, value=80.0)
    market = vast_like_trace(seed=4, days=2)
    pred = ARIMAPredictor(market).matrix(5)
    with tempfile.TemporaryDirectory() as d:
        trainer = ElasticTrainer(cfg, tcfg, job,
                                 calibrate(cfg, bandwidth_bps=800e6),
                                 AHAP(AHAPParams(omega=3, v=1, sigma=0.7)),
                                 market, pred, steps_per_unit=5.0,
                                 ckpt_dir=d)
        zero = jnp.zeros((), jnp.float32)
        trainer._step = lambda p, o, b: (p, o, TrainMetrics(zero, zero,
                                                            zero))
        rep = trainer.run()
    return {"slots": tuple((s.t, s.n_od, s.n_spot, s.mu, s.steps)
                           for s in rep.slots),
            "total_steps": rep.total_steps, "utility": rep.utility,
            "cost": rep.cost, "completion_time": rep.completion_time}


def main():
    t0 = time.perf_counter()
    tr = train_ref()
    print(f"train: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    ssm = train_ssm_ref()
    print(f"train ssm: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    fam = train_fam_ref()
    print(f"train families: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    t0 = time.perf_counter()
    dense = train_dense_ref()
    print(f"train dense: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    dense_serve = dense_serve_ref()
    print(f"serve dense: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    el = elastic_ref()
    print(f"elastic: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print("TRAIN_REF = {")
    for mb, row in tr.items():
        print(f"    {mb}: {{")
        for k, v in row.items():
            print(f"        {k!r}: {v!r},")
        print("    },")
    print("}")
    _print_by_arch("TRAIN_SSM_REF", ssm)
    _print_by_arch("TRAIN_FAM_REF", fam)
    _print_by_arch("TRAIN_DENSE_REF", dense)
    print("DENSE_REFS = {")
    for arch, (seed, prompt, max_len, tokens) in dense_serve.items():
        print(f"    {arch!r}: ({seed}, {prompt}, {max_len}, (")
        for row in tokens:
            print(f"        {row!r},")
        print("    )),")
    print("}")
    print("ELASTIC_REF = {")
    print('    "slots": (')
    for slot in el["slots"]:
        print(f"        {slot!r},")
    print("    ),")
    for k in ("total_steps", "utility", "cost", "completion_time"):
        print(f"    {k!r}: {el[k]!r},")
    print("}")


if __name__ == "__main__":
    main()
