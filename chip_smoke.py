#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repo root, with no arguments:

    python3 chip_smoke.py

It builds the kernels (``src/repro_torch/kernels/csrc/*.cu``: K1
window_dp, K2 lora_matmul, K3 flash_attention and its backward
flash_attention_bwd, K4 ssd_scan and its backward ssd_scan_bwd), one nvcc
for sm_90a each, all started together, and then drives these paths on the
card:

- the paper's online policy selection (Fig. 9: four noise settings, 1000
  jobs x ``paper_pool()``) through ``engine.simulate_and_select``, whose
  window solve is K1's forecast entry (one launch a market slot, the
  window's tables built inside it), with both K1 entries held bit for bit
  against their plain versions (random tables and rows, ties, and every
  slot's real rows of one setting), winners checked against the JAX
  reference and the plain-chain run, and one setting traced;
- dense-model serving: K2 and K3 held against their plain versions, the
  llama2-7b smoke config served greedily and checked token for token against
  the JAX ``ServingEngine``, then llama2-7b at full width and depth (bf16)
  serving 8 prompts of 1024 tokens for 32 new tokens each through
  ``ServingEngine``, with the launch counts checked and every forward's
  logits held against the same model run on the plain versions;
- SSM serving: K4 held against its plain version in the TPU kernel's
  flattened layout and in the model's own (x, B and C strided views of one
  buffer, B and C per group), the mamba2-370m smoke
  config checked token for token against the JAX engine, then mamba2-370m
  at full width and depth (bf16) serving 8 prompts of 2048 tokens for 16
  new tokens, checked as the dense run;
- hybrid serving: the same for zamba2-2.7b (8 prompts of 1024 tokens), whose
  forward runs K2, K3 (head_dim 80) and K4 together;
- the selection path's stress workloads on the 124-lane pool, each slot's
  window solve through K1's forecast entry: the chaos sweep (``[chaos]``:
  1000 jobs, 0 / 1 / 2 preemption storms with stale forecasts, each run
  without and with the prediction-failure monitor and the flight
  recorder; one run traced) and the scenario grid (``[grid]``: 48 market
  regimes x 16 jobs, one ``collect=True`` pass), held against the JAX
  reference's winners, fallback events and winner map;
- the regional selection path (``[region]``: benchmarks/region_e2e.py's
  1000 jobs x the 36-lane ``region_pool()`` x 3 regions x 16 slots, chunks
  of 256 through a double-buffered ``prep=`` closure, flat and with
  per-region on-demand prices; one K1 forecast-entry launch a slot a
  chunk), held against the JAX reference's winner, iters-to-half,
  migrations and regret, ``prep=`` bit-equal to the arrays, migrations
  reconciled, one run traced;
- the host reference chain (``[oracle]``: the python policies, the
  regional and single-region reference simulators, the offline optimum)
  against the vectorized lanes on the card, each python AHAP window on
  K1's table entry;
- fleet contention (``[fleet]``: benchmarks/fleet_sim.py's full size, an
  EG pilot admitting 1000 jobs onto one spot pool for 15 slots through
  ``fleet.simulate_fleet``, one K1 forecast-entry launch a slot), held
  against the JAX reference's admission, grants and utilities, the
  plain-DP run bit for bit (K1 on every slot's real rows) and the port's
  ``MultiJobScheduler`` (each python AHAP window on K1's table entry);
- the seed path (``[seed]``: every lane runs every rule, K1 over all 1000
  jobs x 112 lanes a slot) bit-equal to the partitioned path, and the
  sharded selection engines (``[shard]``: ranks spawned from this script
  on the one card, an NCCL world of one and gloo worlds of 2, 3 and 4 on
  the pool meshes (n,), (2, 2) and (1, 4), each running the Fig. 9
  setting, ``[region]``'s p_od run and ``[fleet]``'s admission through
  the sharded entry points), every rank bit-equal to the unsharded runs
  on the card and the JAX constants held;
- MoE serving: the mixtral-8x7b smoke config token for token against the
  JAX engine (``[serve-moe-ref]``, prompts past its window), then
  mixtral-8x7b at its published width, 16 of its 32 layers, bf16
  (``[serve-moe]``: K2 on q and v, K3 with the sliding window, the experts
  on cuBLAS), its routing swaps against the plain run counted and its
  logits held where the routing agrees, and the first 4 layers in f32;
- VLM and audio, fed embeddings by the stubbed frontends: K3's position
  inputs held against its plain version (``[k3]``: image spans, repeated and
  non-monotone positions, explicit positions 0, 1, ... bit-equal to the
  index path), the qwen2-vl-7b and hubert-xlarge smoke configs against the
  JAX package's tokens and codebook ids (``[vlm-ref]``, ``[audio-ref]``),
  then qwen2-vl-7b at full width and depth (``[vlm]``: 8 prompts of 1024
  embeddings with a 24 x 32 image span, 16 greedy steps; K2 on q and v, K3
  masked by the M-RoPE temporal positions) and hubert-xlarge (``[audio]``:
  one forward of 8 x 1024 frames; K3 non-causal at head dim 80), each with
  its launch counts checked, its logits held against the plain run and a
  traced prefill or forward.
- LoRA fine-tuning, the paper's workload: K2's autograd Function (forward
  K2, dx by K2 on W^T, B^T, A^T), K3's (forward K3 keeping each row's max
  and sum, backward K3's backward kernel) and K4's (forward K4, backward
  K4's backward kernel) against autograd through the plain versions
  (``[k2-grad]``, ``[k3-grad]``, ``[k4-grad]``; a direct launch under grad
  raises; no plain attention on the card's route), K3's and K4's backward
  kernels also against their full-size plain versions at the training
  shapes; the llama2-7b smoke config trained 4 steps against
  the JAX package's train step (``[train-ref]``); llama2-7b at full width
  and depth, bf16, trained with remat (``[train]``: step 0's LoRA
  gradients finite, non-zero and held against the plain runs in bf16 and
  f32, step time, tokens/s, peak memory, launch counts, a traced step, the
  base weights bit-unchanged); the mamba2-370m and zamba2-2.7b smoke
  configs trained 4 steps against the JAX package (``[train-ssm-ref]``)
  and both at full width and depth the same way as llama2-7b
  (``[train-ssm]``: 8 x 2048 and 8 x 1024, K2, K3 and K4 and their
  backwards, no plain version on either path); and the elastic trainer of
  examples/elastic_finetune_torch.py at its full setting (``[elastic]``:
  the scheduler's plan equal to the JAX package's, AHAP's windows on K1,
  real checkpoint round trips).
- The last five architectures, served and LoRA fine-tuned at their
  published widths: the olmo-1b, granite-20b, qwen1.5-110b,
  command-r-plus-104b and mixtral-8x22b smoke configs served token for
  token against the JAX engine (``[serve-dense-ref]``) and trained 4 steps
  against the JAX package's train step (``[train-dense-ref]``); then each
  at full width, bf16 (``DENSE_RUNS``: olmo-1b and granite-20b whole,
  qwen1.5-110b at 16 of 80 layers, command-r-plus-104b at 8 of 64,
  mixtral-8x22b at 8 of 56), served 8 x 1024 for 32 greedy tokens
  (``[serve-<name>]``: granite's one KV head repeated 48 times before K3
  and its v projection at N 128, qwen1.5's q / k / v biases after K2,
  LayerNorm with and without parameters, the tied heads, Mixtral-8x22B's
  MoE layer) and trained on 8 x 1024 tokens (``[train-<name>]``), each
  held as the earlier runs are: logits and gradients against the plain
  runs in bf16 and f32 (at the depth where the f32 copy fits), launch
  counts, no plain attention, the base weights bit-unchanged, a traced
  prefill and step, peak memory beside its prediction.
- The dry run and the step roofline, after every timing: ``[dryrun]``
  runs ``python -m repro_torch.launch.dryrun`` on olmo-1b train_4k at
  full size on (16, 16), over a fake process group of 256 (CPU counts on
  fake tensors, not a run; the smoke combinations are the CPU tests'),
  fails on a FAILED record, and holds the per-device dot FLOPs (2%, after
  layer 0's reference-only backward products) and collective bytes (at
  most 1.25x) to the JAX package's partitioned program, recorded in
  ``JAX_DRYRUN`` by ``tools/jax_dryrun_refs.py``; ``[roofline]`` counts
  llama2-7b's prefill, decode step and training step, and the training
  steps of mamba2-370m and of every other training run, on one device as
  the card
  runs them (K2, K3, K4 and the K3 and K4 backwards by their own traffic
  and operations) and sets each beside its H100 bound and its phase's
  measured time (failing when a
  time is below the compute term, a strict lower bound), the step MFU and
  the counted against the measured peak memory.

It times each kernel beside its bound, its plain version and a PyTorch
yardstick. Any failed phase raises and the script exits nonzero. Without a
CUDA device, or without the repo beside it, it exits nonzero and prints no
result. Its last line is the device JSON.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): device memory
# rate, bf16 dense tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# K1's bound: an H100 SXM's SMs and f32 lanes a clock an SM; an FADD for
# every reachable DP candidate and an FMNMX for every one but a unit's
# first, one issue slot each, at the card's maximum SM clock (nvidia-smi
# clocks.max.sm, read in the run)
H100_SMS = 132
F32_LANES_PER_SM = 128
# K1's time before its redesign (one launch between CUDA events, random
# tables at B = 105,000; NVIDIA H100 80GB HBM3, 700 W)
K1_BEFORE_US = 477.4

SETTINGS = (("magdep_uniform", 0.1), ("fixed_uniform", 0.1),
            ("magdep_heavytail", 0.3), ("fixed_heavytail", 0.3))
N_JOBS = 1000
SEED = 7
B_MAIN, W1, TN = 105_000, 6, 16
DEVICE = "cuda"

# The JAX reference on these inputs: ``benchmarks/fig9_convergence.py``'s
# ``_run_setting(pool, kind, level, 1000, seed=7)`` with the JAX package
# (its fig9_*_best_policy_idx / fig9_*_iters_to_half_weight rows), run on
# the CPU with JAX_PLATFORMS=cpu. (best_policy, iters_to_half,
# regret_ratio, max mean utility) per setting, for paper_pool() and, last,
# for the 124-lane pool paper_pool() + rand_deadline_pool() +
# baseline_specs() at magdep_uniform 0.1.
JAX_REF = {
    ("magdep_uniform", 0.1): (70, 1000, 0.03066767416392615,
                              41.01250076293945),
    ("fixed_uniform", 0.1): (70, 1000, 0.030830402393391985,
                             41.05701446533203),
    ("magdep_heavytail", 0.3): (70, 1000, 0.041638321324941385,
                                40.30770492553711),
    ("fixed_heavytail", 0.3): (70, 1000, 0.04264359224056044,
                               40.38362503051758),
}
JAX_REF_124 = (70, 1000, 0.03944089814469354, 41.01250076293945)
# regret is a small difference of two f32 sums over 1000 jobs taken in
# another order than XLA's: its ratio to the Thm. 2 bound is compared to 2%
# relative; the best lane's mean utility (f32, per-slot bills rounded as
# torch rounds them) to 1e-5 relative
REGRET_RTOL = 0.02
MEAN_U_RTOL = 1e-5

# ---- [chaos] and [grid]: the selection path's two stress workloads on the
# 124-lane pool (src/repro_torch/scenarios.py) ----
# The JAX reference on these inputs, recorded on the CPU by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_chaos_grid_refs.py
# [chaos]: benchmarks/chaos_sweep.py's storm regime at 1000 jobs; per storm
# count, the run without the monitor ("off") and with
# FallbackConfig(threshold=0.5, lam=0.5) ("on", collect=True): (best_policy,
# iters_to_half, regret_ratio, the AHAP lanes' mean utility), and the
# monitored run's (fallback triggers, recoveries, leader switches).
JAX_CHAOS = {
    0: {"off": (122, 1000, 0.0451387179718632, 30.402053833007812),
        "on": (122, 1000, 0.0451387179718632, 30.402053833007812),
        "events": (0, 0, 0)},
    1: {"off": (122, 1000, 0.17750269041773833, 0.8813089728355408),
        "on": (122, 1000, 0.33673394092930187, -3.519151449203491),
        "events": (105000, 105000, 0)},
    2: {"off": (122, 1000, 0.17276341719470303, -33.53268051147461),
        "on": (122, 1000, 0.3522049577150971, -26.47588348388672),
        "events": (105000, 0, 0)},
}
CHAOS_STORMS = (0, 1, 2)
# [grid]: benchmarks/scenario_grid.py's default grid (48 regimes x 16 jobs):
# the winner lane of each regime (argmax of its mean utility), then the
# best fixed lane over the grid
JAX_GRID = ((122, 122, 21, 70, 70, 70, 42, 21, 122, 122, 122, 122, 70, 70,
             70, 21, 70, 123, 70, 70, 70, 70, 70, 70, 18, 42, 12, 12, 39, 42,
             18, 13, 20, 11, 14, 12, 63, 21, 18, 13, 13, 11, 18, 6, 12, 21,
             14, 21), 21)
# grid_ledger's worst cost and utility residuals (f32 totals against the
# ledger's f64 recomposition): the bound tests/test_telemetry.py's
# cost-reconciliation property states
RESIDUAL_BOUND = 1e-3

# ---- [region] and [oracle]: the regional selection path and the host
# reference chain ----
# [region]: benchmarks/region_e2e.py's full size: 1000 jobs x the 36-lane
# region_pool() x 3 phase-shifted regions x 16 slots, fixed_uniform 0.1,
# chunks of 256 jobs through a prep= closure; flat, then with per-region
# on-demand multipliers. The JAX reference on these inputs, recorded on the
# CPU by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_region_refs.py
# per run: (best_policy, iters_to_half, regret_ratio, total migrations).
JAX_REGION = {
    "flat": (29, 1000, 0.1727200057337932, 69510),
    "p_od": (29, 1000, 0.17224633605993128, 69689),
}
REGION_JOBS, REGION_SLOTS, REGION_CHUNK = 1000, 16, 256
REGION_P_OD = (1.0, 1.3, 0.8)
REGION_NOISE = ("fixed_uniform", 0.1)
# one forecast-entry K1 launch a slot a chunk
REGION_LAUNCHES = REGION_SLOTS * -(-REGION_JOBS // REGION_CHUNK)
# the torch-drawn forecast stack against the numpy one: the same winner,
# the regret ratio within this (absolute), as the JAX package holds its
# JAX-PRNG stack
TORCH_PREP_REGRET_ATOL = 0.05
# [oracle]: the python reference chain against the vectorized lanes on the
# card, for ORACLE_JOBS jobs (region lanes on the [region] workload, the
# single-region paper_pool on the first Fig. 9 setting): allocations, region
# paths and migrations exact, utilities to ROADMAP Queue 3, entry 3
ORACLE_JOBS = 6
ORACLE_RTOL, ORACLE_ATOL = 1e-5, 1e-4

# ---- [fleet]: fleet contention at benchmarks/fleet_sim.py's full size ----
# An EG pilot (128 jobs on paper_market(seed=31, days=40), the 124-lane pool,
# fixed_uniform 0.1, seed 13) admits 1000 jobs (SelectionResult.
# admission_rows) that arrive in slots [0, 5) of paper_market(seed=29,
# days=3).window(0, 16) and contend for its spot pool for 15 slots
# (fleet.simulate_fleet: one K1 forecast-entry launch a slot), drawn as
# fleet_sim._workload draws them. The JAX reference on these inputs,
# recorded on the CPU by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_fleet_refs.py
# "pilot": (best_policy, iters_to_half); per admission ("sampled" from the
# pilot's weights, "greedy" on its leader): (bincount of the admitted lanes,
# their CRC32, per-slot sum of spot grants, jobs finished by the deadline,
# sum of the per-job utilities).
JAX_FLEET = {
    'pilot': (70, 128),
    'sampled': ((6, 9, 12, 14, 10, 6, 9, 13, 8, 12, 11, 8, 5, 10, 13, 5, 4,
                 11, 6, 8, 5, 9, 9, 10, 12, 11, 13, 5, 11, 14, 4, 6, 4, 10, 4,
                 8, 5, 10, 13, 13, 9, 11, 6, 13, 9, 10, 9, 9, 10, 9, 9, 11, 8,
                 7, 5, 6, 14, 9, 4, 7, 11, 11, 16, 10, 8, 5, 5, 9, 10, 5, 10,
                 8, 11, 16, 16, 9, 10, 12, 13, 8, 9, 6, 12, 9, 13, 14, 15, 10,
                 9, 9, 7, 10, 10, 11, 6, 6, 8, 12, 7, 11, 8, 9, 10, 4, 11, 2,
                 1, 0, 1, 0, 2, 1, 2, 0, 1, 2, 3, 1, 2, 1, 0, 1, 7, 3),
                1333721207, (2, 2, 2, 3, 3, 3, 5, 4, 3, 4, 5, 6, 7, 9, 0), 3,
                23575.93614578247),
    'greedy': (tuple(1000 if i == 70 else 0 for i in range(124)), 1026362627,
               (2, 2, 2, 3, 3, 3, 5, 4, 3, 4, 5, 6, 7, 9, 0), 0,
               27522.634742736816),
}
FLEET_JOBS, FLEET_SPAN, FLEET_DEADLINE = 1000, 5, 10
FLEET_SLOTS = FLEET_SPAN + FLEET_DEADLINE
FLEET_PILOT, FLEET_SEED = 128, 13
FLEET_NOISE = ("fixed_uniform", 0.1)
# the utility sum is an f32 sum over 1000 jobs whose bills round per slot as
# torch rounds them (ROADMAP Queue 3, entry 3); the oracle (python f64
# around the engine's f32 execution) matches each job to 1e-2, the JAX
# bench's fleet_sim_utility_match tolerance
FLEET_USUM_RTOL = 1e-5
FLEET_ORACLE_ATOL = 1e-2

# ---- [seed] and [shard]: the seed path and the sharded selection engines --
# [seed]: fast_sim.simulate_pool_jobs_monolithic (every lane runs every rule,
# K1 over all 1000 jobs x 112 lanes = 112,000 rows a slot) at the first
# Fig. 9 setting, bit-equal to the partitioned simulate_pool_jobs.
# [shard]: worlds of ranks spawned from this script after the build, every
# rank on the one card and loading the built libraries: NCCL for a world of
# one, gloo for ranks that share the card (NCCL refuses two ranks on one
# GPU). Each world runs its pool meshes: the Fig. 9 setting (1000 jobs x
# paper_pool()), [region]'s p_od run (1000 jobs x 36 lanes x 3 regions,
# chunks of REGION_CHUNK) and [fleet]'s sampled admission (1000 jobs), each
# with collect=True, bit-equal on every rank to the unsharded run on the
# card, with JAX_REF, JAX_REGION and JAX_FLEET held. The fleet shards
# "jobs" only, so it skips the (1, n) mesh, where it would fall through.
SHARD_WORLDS = (("nccl", 1, ((1,),)), ("gloo", 2, ((2,),)),
                ("gloo", 3, ((3,),)), ("gloo", 4, ((4,), (2, 2), (1, 4))))
SHARD_TIMEOUT = 300          # seconds, a world's ranks and its process group

# ---- dense-model serving ----
# [serve-ref]: the llama2-7b smoke config (2 layers, d 256, f32) with
# ``convert.random_model_params(cfg, SERVE_REF_SEED)`` (LoRA B non-zero),
# serving the prompts of :func:`serve_ref_prompts` greedily for 8 new
# tokens with max_len 64. SERVE_REF_TOKENS are the JAX package's
# ``repro.serve.ServingEngine`` tokens on the same numpy weights, run on the
# CPU with JAX_PLATFORMS=cpu (tests/test_torch_serve.py recomputes them).
SERVE_REF_ARCH = "llama2-7b"
SERVE_REF_SEED = 12
SERVE_REF_NEW = 8
SERVE_REF_MAX_LEN = 64
SERVE_REF_TOKENS = (
    (327, 498, 327, 284, 460, 56, 509, 18),
    (211, 76, 93, 234, 76, 93, 290, 93),
    (368, 197, 483, 422, 483, 101, 248, 248),
    (140, 191, 320, 454, 225, 96, 495, 379),
)
# [serve]: llama2-7b at full width and depth, bf16, weights drawn on the
# card (LoRA B ~ N(0, SERVE_LORA_B_STD), not the zero init)
SERVE_ARCH = "llama2-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 8, 1024, 32, 2048
SERVE_LORA_B_STD = 0.02
# Every forward's last-position logits of the kernel run against the same
# model on the plain versions, teacher-forced on the kernel run's tokens.
# The two runs differ only in the order of f32 sums inside K2 and K3; each
# difference surfaces as a one-ulp flip of a bf16 rounding, and the logits
# are themselves a bf16 product (one ulp is 2^-5 = 0.031 for |logit| in
# [4, 8)). Bound: 8 such ulps.
SERVE_LOGIT_ATOL = 0.25

# K2 / K3 against their plain versions on the card. Both kernels and both
# plain versions compute in full f32, so at f32 only the order of the sums
# differs (K2 1e-4, K3 2e-5); at bf16 each rounds one f32 result once, so an
# output may differ by one bf16 ulp (at most 2^-7 relative) where the two
# f32 results straddle a rounding boundary.
K2_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 1e-3)}
K3_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-3)}
# K4 against its plain version (step by step, f32): K4 takes 64-step chunks
# and a shuffle-scan cumsum, so the f32 sums run in another order; 3e-4 is
# the JAX kernel test's own tolerance for the chunked kernel against the
# sequential oracle. At bf16 y is one rounding of those f32 results, so it
# may differ by one bf16 ulp (2^-7 relative) besides; the f32 state keeps
# 3e-4 (K4's bf16 path feeds its f32 operands to the tensor cores as hi + lo
# bf16 halves, about 2^-16: tests/test_torch_kernel_numerics.py).
K4_TOL = {"float32": (3e-4, 3e-4), "bfloat16": (2.0 ** -7, 1e-3)}
TIME_REPS = 25
# K2's decode rows are timed cold: each round of launches rotates through
# copies of the inputs larger than twice the H100's 50 MB L2
COLD_BYTES = 100_000_000
# K2's, K3's and K4's times before their tensor-core redesigns (us a
# launch, NVIDIA H100 80GB HBM3 at 700 W; event pairs around single
# launches, so host enqueue included; the K2 decode rows L2-warm; K4 in the
# flattened layout), printed beside this run's
BEFORE_US = {"prefill": 6895.6, "decode": 245.6, "mamba2-prefill": 1690.2,
           "mamba2-decode": 76.7, "zamba2-prefill": 5338.6,
           "zamba2-decode": 156.2, "flash_attention": 2915.6,
           "flash_attention/zamba2": 1945.5, "ssd_scan/mamba2": 2477.5,
           "ssd_scan/zamba2": 1324.6}
# K4's backward before its tensor-core redesign (us a launch, f32 on the
# CUDA cores; 5 launches in a CUDA graph, NVIDIA H100 80GB HBM3 at 700 W,
# two runs of this script), printed beside this run's
K4_BWD_BEFORE_US = {"mamba2-370m": (4810.3, 4816.9),
                    "zamba2-2.7b": (3796.9, 3807.1)}

# ---- SSM and hybrid serving ----
# [serve-ssm-ref] / [serve-hybrid-ref]: the mamba2-370m and zamba2-2.7b smoke
# configs (2 layers, d 256, f32; zamba2's as 2 super-blocks of one Mamba2
# layer and the shared block), served as [serve-ref] with
# ``convert.random_model_params(cfg, seed)`` and ``serve_ref_prompts(np,
# vocab, seed)``. The tokens are the JAX ``ServingEngine``'s on the same
# numpy weights, run on the CPU with JAX_PLATFORMS=cpu
# (tests/test_torch_serve.py recomputes them).
FAMILY_REFS = {
    "serve-ssm-ref": ("mamba2-370m", 14, (
        (338, 132, 122, 259, 73, 98, 439, 292),
        (218, 394, 247, 264, 50, 249, 114, 237),
        (433, 125, 326, 355, 361, 466, 465, 367),
        (172, 136, 314, 218, 188, 222, 77, 500),
    )),
    "serve-hybrid-ref": ("zamba2-2.7b", 16, (
        (338, 215, 43, 158, 361, 409, 325, 301),
        (51, 90, 506, 238, 269, 20, 147, 162),
        (49, 155, 99, 122, 281, 281, 394, 279),
        (402, 421, 39, 383, 115, 306, 431, 102),
    )),
}
# [serve-ssm] / [serve-hybrid]: full width and depth, bf16, weights drawn on
# the card (LoRA B ~ N(0, SERVE_LORA_B_STD)): (arch, batch, prompt length,
# new tokens, max_len). mamba2-370m reads prompts of its 2048-token training
# context; zamba2-2.7b 1024-token prompts into a 2048-slot KV cache. These
# paths, [serve-moe]'s and [vlm]'s decode 16 tokens ([serve] and DENSE_RUNS'
# 32), to keep the script's time within its limit: their decode steps are
# host-bound at 90-190 ms each on an NVIDIA H100 80GB HBM3, 700.00 W.
#
# Their logits are held to the plain run twice. (1) The same weights
# widened to f32, kernel run against plain run: f32 throughout, only the
# order of the sums inside K2, K3 and K4 differs, so within F32_LOGIT_ATOL.
# (2) bf16, kernel run against plain run: each bf16 run drifts from the f32
# model by its own rounding through 48-54 layers, so the bound is twice the
# plain bf16 run's largest distance from the f32 plain run, measured in the
# same call (the kernels may add no drift beyond bf16's own). A fixed bound
# like SERVE_LOGIT_ATOL, set for 32 dense layers, does not carry over to
# these depths.
F32_LOGIT_ATOL = 1e-3
FAMILY_RUNS = {
    "serve-ssm": ("mamba2-370m", 8, 2048, 16, 2080),
    "serve-hybrid": ("zamba2-2.7b", 8, 1024, 16, 2048),
}

# ---- MoE serving ----
# [serve-moe-ref]: the mixtral-8x7b smoke config (2 layers, d 256, 4 experts
# top-2, sliding window 64, f32) with ``convert.random_model_params(cfg,
# seed)``, 4 prompts of 72 tokens from ``serve_ref_prompts(np, vocab, seed,
# 72)`` (past the window: K3's window masks the prefill and the decode ring
# buffer wraps), 8 greedy new tokens, max_len 96. The tokens are the JAX
# ServingEngine's on the same numpy weights, run on the CPU with
# JAX_PLATFORMS=cpu (tests/test_torch_moe.py recomputes them).
MOE_REF = ("mixtral-8x7b", 18, 72, (
    (485, 425, 201, 96, 129, 169, 129, 486),
    (17, 220, 327, 312, 144, 232, 415, 350),
    (369, 130, 17, 8, 146, 130, 256, 66),
    (267, 104, 405, 89, 457, 82, 362, 205),
))
MOE_REF_MAX_LEN = 96
# [serve-moe]: mixtral-8x7b (arXiv:2401.04088) at its published width, 8
# experts top-2, heads, window and vocabulary, bf16, LoRA rank 16 on q and v,
# weights drawn on the card tensor by tensor; depth cut to MOE_LAYERS of its
# 32 layers (32 layers of 1,451.3 M parameters are 92.9 GB in bf16, more
# than the card holds). (arch, batch, prompt, new tokens, max_len).
MOE_RUN = ("mixtral-8x7b", 8, 1024, 16, 2048)
MOE_LAYERS = 16
# The kernel run and the plain run differ in the router's input by K2's and
# K3's roundings, so a token whose 2nd and 3rd largest router logits nearly
# tie may take another expert: a swap. Every swap must follow from the two
# runs' router logits (the plain run's 2nd - 3rd gap at most twice their
# largest difference at that token), and at the first layer, where only one
# layer's K2 and K3 roundings separate the runs, within ROUTE_SWAP_MARGIN of
# a tie. Deeper, the reference's random init (experts' std 1/sqrt(E), a
# gated product of two ~22-sigma projections) amplifies any difference from
# layer to layer, so at 16 layers the logits are reported, not bounded. They
# are held at MOE_F32_LAYERS layers (full width, f32 23 GB beside the bf16
# ones), at forwards whose last token took the same experts in every layer
# in all four runs: f32 kernel run against f32 plain run within
# F32_LOGIT_ATOL; bf16 kernel run against bf16 plain run within twice the
# bf16 plain run's distance from the f32 plain run (FAMILY_RUNS' rule).
ROUTE_SWAP_MARGIN = 0.1
MOE_F32_LAYERS = 4

# ---- VLM and audio (embeddings in; K3 with positions) ----
# [vlm-ref]: the qwen2-vl-7b smoke config (2 layers, d 256, f32, M-RoPE
# sections (8, 12, 12)) with ``convert.random_model_params(cfg, seed)``:
# ``frontend_ref_inputs``' 4 x 64 embeddings, positions from
# ``make_mrope_positions`` with one image span (start 8, h 4, w 8), a
# prefill, then 8 greedy decode steps, each fed the text-table row of the
# previous argmax token. VLM_REF_TOKENS are the argmax tokens of the
# prefill and of every step from the JAX package on the same numpy inputs
# (``tools/jax_vlm_audio_refs.py``, on the CPU; tests/test_torch_vlm.py
# recomputes them). (arch, seed, batch, prompt, span, new, max_len)
VLM_REF = ("qwen2-vl-7b", 22, 4, 64, (8, 4, 8), 8, 80)
VLM_REF_TOKENS = (
    (358, 224, 139, 429, 505, 339, 139, 455, 177),
    (16, 473, 377, 316, 501, 16, 97, 382, 391),
    (175, 14, 208, 14, 406, 86, 471, 477, 308),
    (297, 85, 345, 390, 485, 316, 430, 141, 172),
)
# [audio-ref]: the hubert-xlarge smoke config (2 layers, d 256, f32), one
# forward of ``frontend_ref_inputs``' 4 x 64 frame embeddings: the CRC32 of
# the per-frame argmax codebook ids (int32) and the logits at
# AUDIO_REF_SAMPLE, from the same tool (tests/test_torch_audio.py
# recomputes them), the logits within AUDIO_REF_ATOL. (arch, seed, batch,
# frames)
AUDIO_REF = ("hubert-xlarge", 24, 4, 64)
AUDIO_REF_SAMPLE = (slice(None), slice(None, None, 16), slice(None, None, 128))
AUDIO_REF_IDS_CRC = 2587094768
AUDIO_REF_LOGITS = (
    -0.662558913230896, 0.8027782440185547, 0.4078976809978485,
    -0.2313133180141449, -0.8931069374084473, 0.5514059066772461,
    0.19412872195243835, -0.16850757598876953, -0.5546379685401917,
    0.5079171061515808, 0.3364720344543457, -0.3347473442554474,
    -0.8995299935340881, 0.8333830237388611, 0.11470159143209457,
    -0.21223121881484985, -0.624107301235199, 0.14932961761951447,
    0.4134538173675537, -0.14325343072414398, -0.7543573975563049,
    0.3602197766304016, 0.25455135107040405, -0.3142413794994354,
    -0.9142791628837585, 0.21207112073898315, 0.3778885006904602,
    -0.10171341150999069, -0.7816699147224426, 0.11418893188238144,
    0.3262958824634552, -0.19599458575248718, -0.33144494891166687,
    0.08851263672113419, 0.21107201278209686, -0.1872393637895584,
    -0.5361343026161194, 0.45523783564567566, 0.3116553723812103,
    -0.05960841104388237, -0.1603880226612091, 0.1520208716392517,
    0.31379884481430054, -0.22460994124412537, -0.5104324221611023,
    0.4326935112476349, 0.19993090629577637, -0.007125413045287132,
    -0.21210968494415283, 0.09483576565980911, 0.10218338668346405,
    -0.3371135890483856, -0.20802247524261475, 0.21255148947238922,
    -0.14832645654678345, -0.655278742313385, -0.3688316345214844,
    0.5021016001701355, -0.2672092020511627, -0.6993741393089294,
    -0.21973419189453125, 0.24573926627635956, 0.1189928874373436,
    -0.5415904521942139,
)
AUDIO_REF_ATOL = 1e-4
# [vlm]: qwen2-vl-7b (arXiv:2409.12191) at full width and depth, bf16, LoRA
# rank 16 on q and v, weights and a text table (the stubbed frontend's
# token embeddings, vocab x d) drawn on the card: 8 prompts of 1024
# embeddings, each with one 24 x 32 image span at position 64 (768 patches,
# a 672 x 896 image at Qwen2-VL's 28-pixel merged patch), then 16 greedy
# steps as in [vlm-ref]. (arch, batch, prompt, span, new, max_len)
VLM_RUN = ("qwen2-vl-7b", 8, 1024, (64, 24, 32), 16, 1056)
# [audio]: hubert-xlarge (arXiv:2106.07447) at full width and depth (48
# layers), bf16: one forward of 8 x 1024 frames (~20 s of 16 kHz audio at
# 20 ms frames). (arch, batch, frames)
AUDIO_RUN = ("hubert-xlarge", 8, 1024)
# Both runs' logits, kernel run against plain run, under FAMILY_RUNS' rule:
# bf16 within twice the bf16 plain run's distance from the f32 plain run, at
# full depth and at FAMILY_F32_LAYERS layers, where the weights widened to
# f32 also hold the kernel run within F32_LOGIT_ATOL.
FAMILY_F32_LAYERS = 4

# [k2-grad]: K2's autograd Function (forward K2, dx by K2 on W^T, B^T, A^T,
# dA and dB rank-r f32 products) against torch.autograd through the plain
# version, at llama2-7b's q shape, Mixtral's v shape (N 1024), qwen2-vl-7b's
# q and v shapes (d 3584; v N 512), hubert-xlarge's q / v shape (d 1280),
# DENSE_RUNS' q and v shapes (olmo-1b's d 2048; granite-20b's d 6144, its v
# N 128 (one KV head), so that its dx runs at K 128; qwen1.5-110b's d 8192,
# command-r-plus-104b's d 12288, each v N 1024; mixtral-8x22b's q as
# granite's, its v N 1024), tiny-100m's q / v shape on [elastic]'s path (8 x
# 128 tokens, d 768) and two odd shapes (M off the tile, r 8 and 64); (M, K,
# N, r). Every training path's forward shape must be here
# (``_k2_train_rows``). y within K2_TOL; dx (one K2 launch) and dA / dB (f32
# products on both sides, summed in another order, rounded once to the
# operands' dtype) within GRAD_TOL.
K2_GRAD_SHAPES = ((8192, 4096, 4096, 16), (8192, 4096, 1024, 16),
                  (8192, 3584, 3584, 16), (8192, 3584, 512, 16),
                  (8192, 1280, 1280, 16),
                  (8192, 2048, 2048, 16), (8192, 6144, 6144, 16),
                  (8192, 6144, 128, 16), (8192, 8192, 8192, 16),
                  (8192, 8192, 1024, 16), (8192, 12288, 12288, 16),
                  (8192, 12288, 1024, 16), (8192, 6144, 1024, 16),
                  (1024, 768, 768, 16), (1000, 512, 768, 8),
                  (333, 1024, 256, 64))
# [train-ref]: the llama2-7b smoke config (f32, 2 layers, d 256) with
# convert.random_model_params(cfg, TRAIN_REF_SEED) weights and
# ShardedLMLoader(vocab, batch, seq, seed=TRAIN_REF_SEED) batches, 4 steps
# of make_train_step for each TrainConfig below (kwargs), on the card.
# TRAIN_REF holds the JAX package's jitted make_train_step on the CPU on the
# same numpy inputs (from tools/jax_train_refs.py): each step's loss, grad
# norm and lr, and the LoRA leaves' movement over the 4 steps (sum of
# |after - before| and of its squares, f64).
TRAIN_REF_ARCH = "llama2-7b"
TRAIN_REF_SEED = 14
TRAIN_REF_STEPS = 4
TRAIN_REF_RUNS = {
    1: dict(seq_len=64, global_batch=4, lr=2e-3, warmup_steps=2,
            total_steps=20, microbatches=1, remat="none"),
    2: dict(seq_len=64, global_batch=4, lr=2e-3, warmup_steps=2,
            total_steps=20, microbatches=2, remat="full"),
}
TRAIN_REF = {
    1: {
        'loss': (6.290581226348877, 6.301862716674805, 6.314222812652588, 6.300570964813232),
        'grad_norm': (0.35814765095710754, 0.3773376941680908, 0.36677634716033936, 0.3453243672847748),
        'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
        'move_abs': 108.36910602832052,
        'move_sq': 0.48424212067343586,
    },
    2: {
        'loss': (6.290581703186035, 6.3018622398376465, 6.31422233581543, 6.300571918487549),
        'grad_norm': (0.35814765095710754, 0.3773376941680908, 0.36677640676498413, 0.3453243672847748),
        'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
        'move_abs': 108.36910642175462,
        'move_sq': 0.4842421250897805,
    },
}
# [train-ssm-ref]: the same runs on the mamba2-370m and zamba2-2.7b smoke
# configs (f32, 2 layers, d 256, N 16, P 32; zamba2's shared attention
# block after each), K2, K4 forward and K4's backward kernel (and K3 for
# zamba2) on the card; TRAIN_SSM_REF from tools/jax_train_refs.py, held
# within TRAIN_REF_RTOL.
TRAIN_SSM_ARCHS = ("mamba2-370m", "zamba2-2.7b")
TRAIN_SSM_REF = {
    'mamba2-370m': {
        1: {
            'loss': (6.311740875244141, 6.310910701751709, 6.2799201011657715, 6.28609037399292),
            'grad_norm': (0.35621070861816406, 0.3457562029361725, 0.3592727780342102, 0.3503274917602539),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 162.6069953162146,
            'move_sq': 0.7259793197924962,
        },
        2: {
            'loss': (6.311741828918457, 6.310911655426025, 6.2799201011657715, 6.28609037399292),
            'grad_norm': (0.35621073842048645, 0.3457562327384949, 0.3592727780342102, 0.3503274619579315),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 162.60700696887992,
            'move_sq': 0.725979330289577,
        },
    },
    'zamba2-2.7b': {
        1: {
            'loss': (6.323063373565674, 6.249260425567627, 6.29502534866333, 6.289777755737305),
            'grad_norm': (0.4170707166194916, 0.41770634055137634, 0.41536760330200195, 0.4223538339138031),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 217.06604938499083,
            'move_sq': 0.970797681524198,
        },
        2: {
            'loss': (6.323063850402832, 6.249259948730469, 6.295024871826172, 6.2897772789001465),
            'grad_norm': (0.4170707166194916, 0.41770634055137634, 0.41536763310432434, 0.4223538935184479),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 217.06604225369517,
            'move_sq': 0.9707976438804526,
        },
    },
}
# [train-fam-ref]: the same runs on the mixtral-8x7b, qwen2-vl-7b and
# hubert-xlarge smoke configs (f32, 2 layers, d 256; Mixtral's 4 experts
# top-2 with window 64; Qwen2-VL's M-RoPE sections (8, 12, 12)), each step's
# batch from ``train_ref_batch``: ShardedLMLoader tokens for Mixtral; for the
# two embedding families numpy embeddings and targets, Qwen2-VL's positions
# with the image span TRAIN_FAM_SPAN (K3 and its backward on the position
# path), HuBERT's loss mask (each frame masked with probability
# TRAIN_FAM_MASK_P; K3 non-causal). TRAIN_FAM_REF from tools/jax_train_refs.py,
# held within TRAIN_REF_RTOL.
TRAIN_FAM_ARCHS = ("mixtral-8x7b", "qwen2-vl-7b", "hubert-xlarge")
TRAIN_FAM_SPAN = (8, 4, 8)
TRAIN_FAM_MASK_P = 0.3
TRAIN_FAM_REF = {
    'mixtral-8x7b': {
        1: {
            'loss': (6.3382649421691895, 6.343993186950684, 6.324476718902588, 6.31068229675293),
            'grad_norm': (0.3427622318267822, 0.33971521258354187, 0.33949020504951477, 0.33435946702957153),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.49119797080122,
            'move_sq': 0.42141762428469,
        },
        2: {
            'loss': (6.338266372680664, 6.343993186950684, 6.324477195739746, 6.310683250427246),
            'grad_norm': (0.3427622318267822, 0.33971521258354187, 0.33949014544487, 0.33435946702957153),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.49120282730942,
            'move_sq': 0.4214176460001184,
        },
    },
    'qwen2-vl-7b': {
        1: {
            'loss': (6.305937767028809, 6.287102699279785, 6.267620086669922, 6.28139591217041),
            'grad_norm': (0.3018268048763275, 0.3307804763317108, 0.3351297974586487, 0.33143654465675354),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.29441720672332,
            'move_sq': 0.42087268117912024,
        },
        2: {
            'loss': (6.30593729019165, 6.287101745605469, 6.2676191329956055, 6.28139591217041),
            'grad_norm': (0.3018268048763275, 0.3307804465293884, 0.3351297676563263, 0.33143654465675354),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.29441692995499,
            'move_sq': 0.420872679510546,
        },
    },
    'hubert-xlarge': {
        1: {
            'loss': (6.314915180206299, 6.298286437988281, 6.307444095611572, 6.289300441741943),
            'grad_norm': (0.3985383212566376, 0.3664684295654297, 0.3753402531147003, 0.4402965009212494),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 107.14809202546463,
            'move_sq': 0.4742143222746276,
        },
        2: {
            'loss': (6.305915355682373, 6.298675537109375, 6.305190563201904, 6.290493488311768),
            'grad_norm': (0.3986073434352875, 0.3700908422470093, 0.37292423844337463, 0.44098174571990967),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 106.96057078053161,
            'move_sq': 0.47365963264338307,
        },
    },
}
# f32 on both sides, sums in another order (the CPU test's loss tolerance
# is 1e-5 and holds ~1e-7; the card's K2 / K3 add their own order): loss
# and lr 1e-5, grad norm 1e-4, the leaves' movement 1e-4
TRAIN_REF_RTOL = {"loss": 1e-5, "lr": 1e-5, "grad_norm": 1e-4,
                  "move_abs": 1e-4, "move_sq": 1e-4}
# [train]: llama2-7b (arXiv:2307.09288, the paper's target) at full width
# and depth (32 layers), bf16, LoRA rank 16 on q and v, weights drawn on
# the card (LoRA B ~ N(0, SERVE_LORA_B_STD), so every adapter has a
# gradient), TrainConfig(seq_len=1024, global_batch=8, remat="full"): 2
# warm-up steps, then TRAIN_STEPS timed. (arch, seq, batch)
TRAIN_RUN = ("llama2-7b", 1024, 8)
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
# [train-ssm]: the SSM and hybrid families trained the same way (bf16,
# remat full, LoRA on Mamba2's wx and out_proj, and the shared attention
# block's q and v): mamba2-370m (arXiv:2405.21060) at full width and depth
# (48 layers, d 1024, H 32, N 128, P 64) and zamba2-2.7b (arXiv:2411.15242)
# at full width and depth (54 Mamba2 layers, H 80, N 64, the shared block
# every 6); TRAIN_WARMUP warm-up steps, then TRAIN_SSM_STEPS timed. (arch,
# seq, batch)
TRAIN_SSM_RUNS = (("mamba2-370m", 2048, 8), ("zamba2-2.7b", 1024, 8))
TRAIN_SSM_STEPS = 3
# [train-vlm], [train-audio], [train-moe]: the MoE, VLM and audio families
# trained the same way (bf16, remat full, LoRA rank 16 on q and v, weights
# drawn on the card, TRAIN_WARMUP warm-up steps, then TRAIN_FAM_STEPS
# timed): qwen2-vl-7b at full width and depth on 8 x 1024 embeddings with
# VLM_RUN's 24 x 32 image span, M-RoPE positions and random targets (K3 and
# its backward on the position path); hubert-xlarge at full width and depth
# on ``frontends.make_masked_prediction_batch``'s 8 x 1024 frames (mask p
# 0.08; K3 non-causal at D 80); mixtral-8x7b at MOE_LAYERS of its 32 layers
# (full width, as [serve-moe]) on ShardedLMLoader tokens (K3 with its
# window; the MoE layer's backward in torch ops). Step 0's gradients are
# held as [train]'s at full depth, Mixtral's at MOE_F32_LAYERS layers (see
# ``_cut_grad_gate``). tag -> (arch, seq, batch, layers)
TRAIN_FAM_RUNS = {"train-vlm": ("qwen2-vl-7b", 1024, 8, None),
                  "train-audio": ("hubert-xlarge", 1024, 8, None),
                  "train-moe": ("mixtral-8x7b", 1024, 8, MOE_LAYERS)}
TRAIN_FAM_STEPS = 3

# ---- the last five architectures: MQA, biases, LayerNorm, tied heads ----
# [serve-dense-ref]: the smoke configs of olmo-1b (LayerNorm without
# parameters, a tied head), granite-20b (one KV head), qwen1.5-110b (q / k /
# v biases), command-r-plus-104b (LayerNorm, a tied head, rope theta 7.5e7)
# and mixtral-8x22b (4 experts top-2, window 64), 2 layers, d 256, f32, with
# ``convert.random_model_params(cfg, seed)`` (LoRA B, biases and norm
# parameters non-zero), served as [serve-ref]: ``serve_ref_prompts(np,
# vocab, seed, prompt)``, 8 greedy new tokens, max_len; Mixtral's prompts
# past its window. The tokens are the JAX ServingEngine's on the same numpy
# weights, on the CPU (tools/jax_train_refs.py; tests/test_torch_serve.py
# recomputes them). arch -> (seed, prompt, max_len, tokens)
DENSE_REFS = {
    'olmo-1b': (30, 16, 64, (
        (420, 296, 428, 428, 455, 96, 442, 46),
        (219, 249, 480, 33, 301, 301, 342, 342),
        (456, 262, 456, 388, 461, 134, 173, 173),
        (235, 149, 462, 451, 162, 173, 62, 462),
    )),
    'granite-20b': (31, 16, 64, (
        (120, 97, 367, 212, 212, 187, 367, 163),
        (0, 34, 257, 27, 176, 114, 176, 421),
        (103, 417, 162, 505, 447, 446, 447, 131),
        (34, 157, 468, 113, 9, 157, 251, 389),
    )),
    'qwen1.5-110b': (32, 16, 64, (
        (94, 181, 108, 286, 214, 181, 181, 181),
        (404, 128, 144, 115, 314, 358, 487, 109),
        (389, 371, 170, 401, 342, 470, 311, 314),
        (111, 101, 111, 111, 111, 111, 111, 111),
    )),
    'command-r-plus-104b': (33, 16, 64, (
        (401, 284, 401, 284, 401, 284, 401, 284),
        (282, 171, 282, 171, 435, 93, 282, 362),
        (195, 22, 22, 22, 22, 244, 57, 60),
        (194, 194, 126, 232, 400, 308, 62, 62),
    )),
    'mixtral-8x22b': (34, 72, 96, (
        (170, 262, 370, 436, 502, 205, 66, 91),
        (3, 3, 3, 127, 153, 72, 190, 291),
        (486, 9, 9, 40, 252, 333, 486, 486),
        (6, 32, 388, 211, 123, 199, 0, 0),
    )),
}
# [train-dense-ref]: [train-ref]'s runs on the same five smoke configs;
# TRAIN_DENSE_REF from tools/jax_train_refs.py, held within TRAIN_REF_RTOL.
TRAIN_DENSE_REF = {
    'olmo-1b': {
        1: {
            'loss': (6.2715959548950195, 6.284593105316162, 6.282033443450928, 6.3141326904296875),
            'grad_norm': (0.3578283190727234, 0.35049957036972046, 0.3683837056159973, 0.357468843460083),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 108.4724590081459,
            'move_sq': 0.48455579797026865,
        },
        2: {
            'loss': (6.2715959548950195, 6.284594535827637, 6.282032012939453, 6.314131736755371),
            'grad_norm': (0.3578283190727234, 0.35049957036972046, 0.3683837056159973, 0.357468843460083),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 108.47245919719745,
            'move_sq': 0.4845557962737147,
        },
    },
    'granite-20b': {
        1: {
            'loss': (6.317312240600586, 6.276528835296631, 6.270867824554443, 6.3333611488342285),
            'grad_norm': (0.3515256345272064, 0.38029226660728455, 0.3488198518753052, 0.38765719532966614),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 87.78657778325453,
            'move_sq': 0.39304145348256275,
        },
        2: {
            'loss': (6.317312240600586, 6.276528835296631, 6.270867824554443, 6.333361625671387),
            'grad_norm': (0.3515256643295288, 0.38029229640960693, 0.3488198518753052, 0.3876572251319885),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 87.78657642451537,
            'move_sq': 0.3930414520095062,
        },
    },
    'qwen1.5-110b': {
        1: {
            'loss': (6.27446985244751, 6.306533336639404, 6.281858444213867, 6.289655685424805),
            'grad_norm': (0.3171249032020569, 0.34886759519577026, 0.34107691049575806, 0.3393726944923401),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.75652286623944,
            'move_sq': 0.4240762956598495,
        },
        2: {
            'loss': (6.27446985244751, 6.306532859802246, 6.281858444213867, 6.289654731750488),
            'grad_norm': (0.3171249032020569, 0.34886762499809265, 0.3410768210887909, 0.3393726944923401),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.75651975339832,
            'move_sq': 0.4240762932267522,
        },
    },
    'command-r-plus-104b': {
        1: {
            'loss': (6.272869110107422, 6.288472652435303, 6.271836280822754, 6.29131555557251),
            'grad_norm': (0.3505774736404419, 0.3663640022277832, 0.4240541458129883, 0.365500807762146),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 93.98607870353032,
            'move_sq': 0.4183495786083838,
        },
        2: {
            'loss': (6.272868633270264, 6.288473129272461, 6.271836280822754, 6.291316032409668),
            'grad_norm': (0.3505774438381195, 0.3663639426231384, 0.4240540564060211, 0.365500807762146),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 93.98608279728762,
            'move_sq': 0.41834961510989627,
        },
    },
    'mixtral-8x22b': {
        1: {
            'loss': (6.3382649421691895, 6.343993186950684, 6.324476718902588, 6.31068229675293),
            'grad_norm': (0.3427622318267822, 0.33971521258354187, 0.33949020504951477, 0.33435946702957153),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.49119797080122,
            'move_sq': 0.42141762428469,
        },
        2: {
            'loss': (6.338266372680664, 6.343993186950684, 6.324477195739746, 6.310683250427246),
            'grad_norm': (0.3427622318267822, 0.33971521258354187, 0.33949014544487, 0.33435946702957153),
            'lr': (0.0010000000474974513, 0.0020000000949949026, 0.0020000000949949026, 0.001986327115446329),
            'move_abs': 94.49120282730942,
            'move_sq': 0.4214176460001184,
        },
    },
}
# [serve-<name>] / [train-<name>]: the five at their published widths, bf16,
# LoRA rank 16 on q and v, weights drawn on the card (``_draw_model``; the
# biases and norm parameters too, as the smoke configs have them, since
# these are the features the runs exist for). Served as [serve] (SERVE_BATCH
# x SERVE_PROMPT, SERVE_NEW greedy tokens, SERVE_MAX_LEN) and trained as
# [train] (TRAIN_RUN's 8 x 1024, remat full, TRAIN_WARMUP + TRAIN_FAM_STEPS
# steps), each arch at one depth in both: olmo-1b (arXiv:2402.00838) and
# granite-20b (arXiv:2405.04324) whole (2.4 and 56.3 GB of bf16 weights);
# qwen1.5-110b at 16 of 80 layers (80 are 222 GB; 16 are 48.5 GB);
# command-r-plus-104b at 8 of 64 (207.6 GB; 31.5 GB, and its training peak
# is the loss over a 256k vocabulary: f32 logits of 8192 x 256,000 are 8.4
# GB, their gradient as much); mixtral-8x22b (arXiv:2401.04088) at 8 of 56
# (281 GB; 40.9 GB). The f32 copy that the logit and gradient gates hold
# the runs to does not fit beside the bf16 weights past olmo-1b, so those
# gates run at the second depth (the deeper layers freed, as
# MOE_F32_LAYERS): the deepest at which the f32 training step fits, where
# command-r-plus-104b's 256k-vocabulary loss leaves room for 2 layers;
# at the full depth the kernel run's distance from the plain run is
# printed. The last pair is the predicted peak memory of the serving run
# and of the training step, GB, printed beside the measured ones: the
# weights, the KV cache and a prefill's transients; the weights, the layer
# inputs that remat keeps, the loss (f32 logits, their logsumexp and
# gradient) and one recomputed layer.
# name -> (arch, layers run (None: all), layers of the f32 gates (None: the
# run's), (serving, training) predicted peak GB)
DENSE_RUNS = {
    "olmo": ("olmo-1b", None, None, (5.0, 9.0)),
    "granite": ("granite-20b", None, 4, (60.0, 70.0)),
    "qwen1.5": ("qwen1.5-110b", 16, 4, (53.0, 70.0)),
    "cmdr": ("command-r-plus-104b", 8, 2, (37.0, 62.0)),
    "moe-8x22b": ("mixtral-8x22b", 8, MOE_F32_LAYERS, (45.0, 50.0)),
}
# [elastic]: examples/elastic_finetune_torch.py's full setting (tiny-100m,
# ~134M parameters, seq 128, batch 8, AHAP(3, 1, 0.7) on
# vast_like_trace(seed=4, days=2) with ARIMA forecasts) on the card. The
# plan does not depend on the losses: ELASTIC_REF is the JAX package's
# ElasticTrainer on the same setting (tools/jax_train_refs.py, its train
# step stubbed): per slot (t, n_od, n_spot, mu, steps), then total_steps,
# utility, cost and completion time, all exact.
ELASTIC_REF = {
    "slots": (
        (0, 6, 4, 0.8984289169311523, 45),
        (1, 4, 6, 1.0, 50),
        (2, 5, 5, 1.0, 50),
        (3, 1, 5, 0.9984288811683655, 30),
        (4, 0, 6, 1.0, 30),
        (5, 0, 6, 1.0, 30),
        (6, 0, 3, 0.9984288811683655, 15),
        (7, 0, 0, 0.9984288811683655, 0),
    ),
    'total_steps': 250,
    'utility': 45.85622580667801,
    'cost': 34.11392800191574,
    'completion_time': 8.002985090017319,
}


def frontend_ref_inputs(np, d: int, vocab: int, seed: int, batch: int,
                        seq: int):
    """[vlm-ref]'s and [audio-ref]'s numpy inputs: embeddings (batch, seq, d)
    and a text table (vocab, d), f32, N(0, 0.02^2) as the frontend stub's
    embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed + 1)
    embeds = (rng.standard_normal((batch, seq, d), np.float32) * 0.02)
    table = (rng.standard_normal((vocab, d), np.float32) * 0.02)
    return embeds.astype(np.float32), table.astype(np.float32)


def train_ref_batch(np, cfg, global_batch: int, seq_len: int, step: int,
                    seed: int = TRAIN_REF_SEED, span=TRAIN_FAM_SPAN,
                    data=None) -> dict:
    """[train-ref]'s, [train-ssm-ref]'s and [train-fam-ref]'s batch of a
    step, numpy arrays from a seed: a token model's ShardedLMLoader tokens;
    an embedding model's embeddings (B, S, d) f32, N(0, 0.02^2) as
    ``frontend_ref_inputs``', and targets (B, S) int32, with M-RoPE
    positions (B, S, 3) of one image span ``span`` (None: text positions)
    where the config has M-RoPE, and a boolean loss mask (each frame with
    probability TRAIN_FAM_MASK_P) for an encoder. ``data`` = (the
    ShardedLMLoader class, make_mrope_positions) of the package that builds
    the batch: the port's by default; tools/jax_train_refs.py gives the JAX
    package's, so that the recorded constants hold the port's too."""
    if data is None:
        from repro_torch.data import ShardedLMLoader
        from repro_torch.models.frontends import make_mrope_positions
    else:
        ShardedLMLoader, make_mrope_positions = data

    if not cfg.embed_inputs:
        return ShardedLMLoader(cfg.vocab_size, global_batch, seq_len,
                               seed=seed).batch_at(step)
    rng = np.random.default_rng((seed, step))
    shape = (global_batch, seq_len)
    batch = {"embeds": (rng.standard_normal(shape + (cfg.d_model,),
                                            np.float32) * 0.02
                        ).astype(np.float32),
             "targets": rng.integers(0, cfg.vocab_size, shape,
                                     dtype=np.int32)}
    if cfg.m_rope:
        batch["positions"] = make_mrope_positions(global_batch, seq_len,
                                                  span)
    if cfg.encoder_only:
        batch["loss_mask"] = rng.random(shape) < TRAIN_FAM_MASK_P
    return batch


def serve_ref_prompts(np, vocab: int, seed: int = SERVE_REF_SEED,
                      length: int = 16):
    """The [serve-ref] (and [serve-ssm-ref], [serve-hybrid-ref],
    [serve-moe-ref]) prompts: 4 x ``length`` tokens from a numpy seed."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, vocab, (4, length)).astype(np.int32)


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _tables(b, w1, tn, seed, torch, dev):
    """Random DP tables with BIG-priced entries (as the JAX kernel test
    builds them), made with numpy from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kw, u1 = tn + 1, w1 * tn + 1
    slot_cost = rng.uniform(0.0, 3.0, (b, w1, kw)).astype(np.float32)
    slot_cost = np.where(rng.random((b, w1, kw)) < 0.3, 1.0e9, slot_cost)
    slot_cost[:, :, 0] = 0.0
    gain = np.cumsum(rng.uniform(0.0, 2.0, (b, u1)), axis=1).astype(
        np.float32)
    return (torch.from_numpy(slot_cost).to(dev),
            torch.from_numpy(gain).to(dev))


def _compare_k1(name, slot_cost, gain, torch, window_dp, window_dp_ref,
                quiet=False):
    """K1 against the plain DP on the same card tensors: bit-equal."""
    launches = window_dp.launches
    n_k, o_k = window_dp(slot_cost, gain)
    torch.cuda.synchronize()
    window_dp.launches = launches      # comparison launches do not count
    n_r, o_r = window_dp_ref(slot_cost, gain)
    torch.cuda.synchronize()
    if not torch.equal(n_k, n_r):
        bad = int((n_k != n_r).any(dim=1).sum())
        _fail(f"K1 n_tot differs from the plain DP on {name}: {bad} rows")
    finite = torch.isfinite(o_r)
    err = float((o_k[finite] - o_r[finite]).abs().max()) if finite.any() \
        else 0.0
    if not torch.equal(o_k, o_r):
        _fail(f"K1 obj differs from the plain DP on {name}: max {err}")
    if not quiet:
        print(f"[k1] {name}: B={slot_cost.shape[0]} w1={slot_cost.shape[1]} "
              f"tn={slot_cost.shape[2] - 1} bit-equal")
    return err


def _tie_tables(b, w1, tn, seed, torch, dev):
    """DP tables that force ties: integer costs (30% BIG) and integer
    gains, with half the rows' every k >= 1 priced out."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kw, u1 = tn + 1, w1 * tn + 1
    cost = rng.integers(0, 4, (b, w1, kw)).astype(np.float32)
    cost = np.where(rng.random((b, w1, kw)) < 0.3, 1.0e9, cost)
    cost[: b // 2, :, 1:] = 1.0e9
    cost[:, :, 0] = 0.0
    gain = np.cumsum(rng.integers(0, 3, (b, u1)), axis=1).astype(np.float32)
    return (torch.from_numpy(cost.astype(np.float32)).to(dev),
            torch.from_numpy(gain).to(dev))


def _forecast_rows(b, w1, tn, seed, torch, dev):
    """Random forecast rows for K1's forecast entry, made with numpy from a
    seed: prices on a 1/8 grid (ties) and above p_o, slots past the
    deadline (slots_to_deadline in [-1, w1 + 1]), n_min up to 3, n_max
    above and below tn, progress past the workload. Returns (job, z0,
    slots_to_deadline, prices, avail) on ``dev``."""
    import numpy as np

    from repro_torch.configs.base import JobConfig

    rng = np.random.default_rng(seed)
    cols = {
        "workload": rng.uniform(5.0, 150.0, b).astype(np.float32),
        "deadline": rng.integers(2, 12, b).astype(np.int32),
        "n_min": rng.integers(1, 4, b).astype(np.int32),
        "n_max": rng.integers(2, tn + 3, b).astype(np.int32),
        "value": rng.uniform(10.0, 300.0, b).astype(np.float32),
        "gamma": rng.uniform(1.1, 3.0, b).astype(np.float32),
        "on_demand_price": rng.choice(
            np.array([1.0, 0.875, 1.3], np.float32), b),
    }
    prices = np.round(rng.uniform(0.05, 1.6, (b, w1)) * 8) / 8
    arrays = (rng.uniform(0, 1.2 * cols["workload"]).astype(np.float32),
              rng.integers(-1, w1 + 2, b).astype(np.int32),
              prices.astype(np.float32),
              rng.integers(0, tn + 3, (b, w1)).astype(np.int32))
    job = JobConfig(**{f: torch.from_numpy(v).to(dev)
                       for f, v in cols.items()})
    return (job,) + tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _compare_k1_rows(name, rows, tput, tn, torch, k1, window_dp_rows_ref):
    """K1's forecast entry against its plain chain (table, DP, split,
    un-bias) on the same card tensors: n_o, n_s and obj bit-equal."""
    launches = (k1.window_dp.launches, k1.window_dp_rows.launches)
    got = k1.window_dp_rows(*rows[:1], tput, *rows[1:], tn)
    torch.cuda.synchronize()
    # comparison launches do not count
    k1.window_dp.launches, k1.window_dp_rows.launches = launches
    want = window_dp_rows_ref(*rows[:1], tput, *rows[1:], tn)
    torch.cuda.synchronize()
    for what, g, w in zip(("n_o", "n_s", "obj"), got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = int((g != w).reshape(g.shape[0], -1).any(dim=1).sum())
            _fail(f"K1 forecast entry {what} differs from the plain chain "
                  f"on {name}: {bad} rows")
    b, w1 = rows[3].shape
    print(f"[k1] forecast entry, {name}: B={b} w1={w1} tn={tn} n_o, n_s, "
          "obj bit-equal")


def _max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0].split()[0])


def _k1_bound(b, w1, tn, row_bytes, clock_mhz):
    """(bound ms, bytes ms, operations ms, candidates, instructions) of one
    K1 launch: the reachable candidates, (tn + 1) x (tau tn + 1) a slot
    (costs >= 0: no unit above tau tn holds a state below BIG before slot
    tau), each an FADD, and an FMNMX for each but the first of every
    reachable unit ((tau + 1) tn + 1 a slot), over the f32 lanes' issue
    rate; the bytes each row reads and writes once over HBM_BYTES_PER_S."""
    cand = b * sum((tn + 1) * (tau * tn + 1) for tau in range(w1))
    units = b * sum((tau + 1) * tn + 1 for tau in range(w1))
    instr = 2 * cand - units
    rate = H100_SMS * F32_LANES_PER_SM * clock_mhz * 1e6
    o_ms = instr / rate * 1e3
    b_ms = b * row_bytes / HBM_BYTES_PER_S * 1e3
    return max(b_ms, o_ms), b_ms, o_ms, cand, instr


def _k1_sass(lib_path):
    """Instruction counts of K1's (w1, tn) = (6, 16) strip kernels in the
    built library's SASS (cuobjdump): FMNMX, FADD, shared-memory loads and
    stores, and local-memory loads and stores (LDL / STL: a spill or a
    dynamically indexed array). Static counts: each strip variant's code
    appears once."""
    import shutil

    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        found = shutil.which("cuobjdump")
        if found is None:
            return None
        tool = Path(found)
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            continue
        if name is None or "window_dp_strips" not in name:
            continue
        c = counts.setdefault(name, {"FMNMX": 0, "FADD": 0, "LDL/STL": 0,
                                     "LDS": 0, "STS": 0})
        # "/*0040*/  @P0 FMNMX R3, R4, R5, !PT ;  /* 0x... */"
        words = line.split("*/", 1)[1].split() if "*/" in line else []
        op = next((w for w in words if not w.startswith("@")), "")
        for key in ("FMNMX", "FADD", "LDS", "STS"):
            if op.startswith(key):
                c[key] += 1
        if op.startswith(("LDL", "STL")):
            c["LDL/STL"] += 1
    return counts


def _ptxas_usage(log: str, pattern: str) -> tuple:
    """From nvcc's ``-Xptxas -v`` log: {the groups of ``pattern`` in a
    kernel's mangled name: its registers, spill stores and loads and stack
    frame} for each kernel whose name matches, and every ptxas line of the
    log that names a wgmma or warns."""
    import re

    usage, name, warnings = {}, None, []
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"Function properties for \S*" + pattern, line)
            name = m.groups() if m else None
            continue
        if "wgmma" in line or "warning" in line.lower():
            warnings.append(f"ptxas: {line.strip()}")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if name and m:
            usage.setdefault(name, {}).update(
                stack=m.group(1), stores=m.group(2), loads=m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            usage.setdefault(name, {})["registers"] = m.group(1)
    return usage, warnings


def _usage_line(u: dict, smem: int) -> str:
    return (f"{u.get('registers')} registers, spill stores "
            f"{u.get('stores')} B, spill loads {u.get('loads')} B, stack "
            f"{u.get('stack')} B; dynamic shared memory {smem:,} B")


def _k3_bwd_usage(log: str, lib) -> list:
    """One line for each bf16 kernel of K3's backward (``_ptxas_usage``):
    the pass, head dim and path, and the dynamic shared memory its launch
    gives it (``flash_attention_bwd_smem_bytes``); then the ptxas lines
    that name a wgmma or warn."""
    usage, warnings = _ptxas_usage(
        log, r"bwd_(kv|q)_bf16_kernelILi(\d+)ELb(\d)E(?:Lb(\d)E)?")
    rows = []
    for (kind, d, pos, dq), u in usage.items():
        what = "dkdv" if kind == "kv" else ("dq" if dq == "1" else "rowdot")
        smem = lib.flash_attention_bwd_smem_bytes(int(d), 1,
                                                  int(kind == "kv"))
        rows.append(((what, -int(d), pos), (
            f"{what} D {d} {'position' if pos == '1' else 'index'} path: "
            + _usage_line(u, smem))))
    return [line for _, line in sorted(rows)] + warnings


def _k4_bwd_usage(log: str, lib) -> list:
    """One line for each bf16 kernel of K4's backward (the states and the
    gradient kernel at each padded state size) as ``_k3_bwd_usage``'s,
    the shared memory from ``ssd_scan_bwd_bf16_smem_bytes``."""
    usage, warnings = _ptxas_usage(log, r"bwd_(states|grad)_bf16_kernelILi"
                                        r"(\d+)E")
    rows = []
    for (kind, npad), u in usage.items():
        smem = lib.ssd_scan_bwd_bf16_smem_bytes(int(npad),
                                                int(kind == "grad"))
        rows.append(((kind, int(npad)), f"{kind} N {npad}: "
                     + _usage_line(u, smem)))
    return [line for _, line in sorted(rows)] + warnings


def _event_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _graph_ms(torch, fn, reps: int = TIME_REPS, rounds: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in one
    CUDA graph, so no host enqueue separates them, replayed ``rounds`` times
    between CUDA events; the median replay over ``reps``. (Event pairs
    around single calls, as ``_event_ms`` takes them, also time the host's
    enqueue, which is most of a short launch.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def _phase_time_k1(torch, k1, tput, window_dp_ref, window_dp_rows_ref,
                   big_c, big_g, big_rows, captured, clock):
    """K1's two entries at B = B_MAIN, (W1, TN): 25 launches in one CUDA
    graph (``_graph_ms``: device time alone) and CUDA events around single
    launches (``event_ms``: also the host's enqueue and the wrapper's
    checks), on the random tables / rows and on each real slot's; the plain
    versions by events. The table entry's real tables are built from the
    real rows in torch ops. Timing launches do not count. Returns
    {"table": row, "forecast": row}."""
    from repro_torch.core.window_opt import _unit_cost_table

    real_tables = []
    for job, *rows in captured:
        c, _, g = _unit_cost_table(job, tput, *rows, job.on_demand_price, TN)
        real_tables.append((c, g))
    u1 = W1 * TN + 1
    entries = {
        # slot_cost, gain in; n_tot, obj out
        "table": (k1.window_dp, window_dp_ref, (big_c, big_g), real_tables,
                  4 * (W1 * (TN + 1) + u1 + W1 + 1)),
        # prices, avail, z0, slots_to_deadline, 7 job fields in; n_o, n_s,
        # obj out
        "forecast": (lambda job, *r: k1.window_dp_rows(job, tput, *r, TN),
                     lambda job, *r: window_dp_rows_ref(job, tput, *r, TN),
                     big_rows, captured, 4 * (2 * W1 + 2 + 7 + 2 * W1 + 1)),
    }
    launches = (k1.window_dp.launches, k1.window_dp_rows.launches)
    out = {}
    for entry, (fn, plain_fn, args, real, row_bytes) in entries.items():
        for _ in range(3):
            fn(*args)
        ms = _graph_ms(torch, lambda: fn(*args))
        events = _event_ms(torch, lambda: fn(*args), TIME_REPS)
        real_ms = [_graph_ms(torch, lambda a=a: fn(*a)) for a in real]
        plain = _event_ms(torch, lambda: plain_fn(*args), 5)
        bound, b_ms, o_ms, cand, instr = _k1_bound(B_MAIN, W1, TN,
                                                   row_bytes, clock)
        out[entry] = {"ms": ms, "event_ms": events, "real_ms": real_ms,
                      "plain_ms": plain, "library_ms": None,
                      "bound_ms": bound, "bound_by": _bound_by(b_ms, o_ms),
                      "bytes_ms": b_ms, "ops_ms": o_ms, "cand": cand,
                      "instr": instr, "bytes": B_MAIN * row_bytes}
    k1.window_dp.launches, k1.window_dp_rows.launches = launches
    return out


class _DeviceRow(NamedTuple):
    """Device events of one name: ``count`` of them, ``self_device_time_
    total`` us in all (the fields ``key_averages`` rows have)."""
    key: str
    count: int
    self_device_time_total: float


def _device_events(prof):
    """The profiled window's device events, one row per name (one stream,
    so they do not overlap), summed from the profiler's raw results:
    ``key_averages`` makes a python object of every host and device event
    first, ~9 s for a regional run's 57,000 device events."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.duration_ns() <= 0):
            continue
        count, us = rows.get(e.name(), (0, 0.0))
        rows[e.name()] = (count + 1, us + e.duration_ns() / 1e3)
    return [_DeviceRow(k, c, us) for k, (c, us) in rows.items()]


def _phase_trace_selection(torch, engine, fast_sim, window_opt, pool, inp,
                           slot_rows, dev):
    """One Fig. 9 setting on the main path. Wall seconds of two runs without
    the profiler; then under ``torch.profiler`` the device busy time (the
    device events' self time; one stream, so they do not overlap) against
    the profiled wall, K1's part, and the device events of the whole
    setting, of the simulate phase a slot (``simulate_pool_jobs``, 10
    slots) and of one ``solve_window_batch`` call on a real slot's rows (10
    calls profiled); and the aten ops that call dispatches, counted by a
    TorchDispatchMode."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.workload import PAPER_TPUT

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket.__name__))
            return func(*args, **(kwargs or {}))

    def select():
        engine.simulate_and_select(pool, inp[0], PAPER_TPUT, *inp[1:])
        torch.cuda.synchronize()

    def solve():
        return window_opt.solve_window_batch(job, PAPER_TPUT, *rows,
                                             job.on_demand_price, TN)

    jobs_d = fast_sim.jobs_to(inp[0], dev)
    job, *rows = slot_rows
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        select()
        walls.append(time.perf_counter() - t0)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        select()
        pwall = time.perf_counter() - t0
    events = _device_events(prof)
    with profile(activities=acts) as prof:
        fast_sim.simulate_pool_jobs(pool, jobs_d, PAPER_TPUT, *inp[1:])
        torch.cuda.synchronize()
    n_sim = sum(e.count for e in _device_events(prof))
    with profile(activities=acts) as prof:
        for _ in range(10):
            solve()
        torch.cuda.synchronize()
    solve_events = _device_events(prof)
    counter = CountOps()
    with counter:
        solve()
    torch.cuda.synchronize()
    n_solve = sum(e.count for e in solve_events) / 10
    print(f"[trace] selection: one solve_window_batch call dispatches "
          f"{len(counter.ops)} aten ops ({', '.join(sorted(set(counter.ops)))}"
          f"); its device events ({n_solve:.1f}): " + "; ".join(
              f"{e.key[:40]} {e.count / 10:.0f}x" for e in sorted(
                  solve_events, key=lambda e: -e.count)[:8]))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    wall_s = ", ".join(f"{w:.4f}" for w in walls)
    if busy == 0:
        print(f"[trace] selection: wall {wall_s} s; device time not measured "
              "(the profiler recorded no device events)")
        return
    k1_ev = [e for e in events if "window_dp" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1_ev) / 1e3
    print(f"[trace] selection {SETTINGS[0]}: wall {wall_s} s (profiled "
          f"{pwall:.4f} s); device busy {busy:.2f} ms = "
          f"{busy / (pwall * 1e3):.1%} of the profiled wall (idle "
          f"{1 - busy / (pwall * 1e3):.1%}); K1 {k1_ms:.3f} ms "
          f"({k1_ms / busy:.1%} of busy, {sum(e.count for e in k1_ev)} "
          f"launches); device events: {sum(e.count for e in events)} in the "
          f"setting, {n_sim / 10:.1f} a slot in the simulate phase, "
          f"{n_solve:.1f} in one solve_window_batch call")


def _engine_inputs(kind, level, engine, workload, np):
    """Fig. 9's inputs exactly as benchmarks/fig9_convergence.py builds
    them (seed 7: jobs, then window starts, per-job predictor seeds)."""
    rng = np.random.default_rng(SEED)
    trace = workload.paper_market(seed=21, days=40)
    jobs = workload.job_stream_arrays(rng, N_JOBS)
    d = int(np.asarray(jobs.deadline)[0])
    t0s = rng.integers(0, len(trace) - d - 1, size=N_JOBS)
    seeds = SEED * 100003 + np.arange(N_JOBS)
    prices, avail, preds = engine.prepare_noisy_inputs(
        trace, t0s, d, kind, level, seeds
    )
    return jobs, prices, avail, preds


def _check_result(name, res, ref, n_pol):
    import numpy as np

    best, t_half, ratio, mean_u = ref
    u = res.utilities
    if u.shape != (N_JOBS, n_pol) or not np.isfinite(u).all():
        _fail(f"{name}: utilities {u.shape} not finite of shape "
              f"({N_JOBS}, {n_pol})")
    if (res.best_policy(), res.iters_to_half()) != (best, t_half):
        _fail(f"{name}: best_policy/iters_to_half "
              f"{(res.best_policy(), res.iters_to_half())} != JAX "
              f"{(best, t_half)}")
    if abs(res.regret_ratio() - ratio) > REGRET_RTOL * ratio:
        _fail(f"{name}: regret_ratio {res.regret_ratio()} vs JAX {ratio}")
    got_u = float(res.mean_utility.max())
    if abs(got_u - mean_u) > MEAN_U_RTOL * abs(mean_u):
        _fail(f"{name}: best mean utility {got_u} vs JAX {mean_u}")


def _pool124():
    from repro_torch.core.policy_pool import (baseline_specs, paper_pool,
                                              rand_deadline_pool,
                                              specs_to_arrays)

    specs = paper_pool() + rand_deadline_pool() + baseline_specs()
    return specs, specs_to_arrays(specs)


def _k1_counts(k1):
    return k1.window_dp.launches, k1.window_dp_rows.launches


def _phase_chaos(np, engine, k1):
    """The chaos sweep's storm regime on the card: 1000 jobs x the 124-lane
    pool, 0 / 1 / 2 storms, each run without the monitor, with it, and with
    it and the flight recorder. Held against JAX_CHAOS; collect changes no
    mean-utility bit; 10 forecast-entry K1 launches a run; the pool
    ledger's fallback block reconciles. Returns (K1 launches, the s = 2
    inputs and config for the trace)."""
    from repro_torch import scenarios as sc
    from repro_torch.chaos import FallbackConfig
    from repro_torch.core.policy_pool import KIND_AHAP
    from repro_torch.obs import pool_ledger, selection_ledger
    from repro_torch.workload import PAPER_TPUT

    _, pool = _pool124()
    ahap = pool["kind"] == KIND_AHAP
    cfg = FallbackConfig(threshold=sc.CHAOS_THRESHOLD, lam=sc.CHAOS_LAM)
    modes = (("off", {}), ("on", dict(fallback=cfg)),
             ("collect", dict(fallback=cfg, collect=True)))
    k1.window_dp.launches = k1.window_dp_rows.launches = 0
    ahap_u = {}
    for s in CHAOS_STORMS:
        t0 = time.perf_counter()
        jobs, prices, avail, preds, sched = sc.chaos_inputs(s, N_JOBS)
        prep_s = time.perf_counter() - t0
        res, wall = {}, {}
        for mode, kw in modes:
            before = _k1_counts(k1)
            t0 = time.perf_counter()
            res[mode] = engine.simulate_and_select(
                pool, jobs, PAPER_TPUT, prices, avail, preds,
                return_utilities=True, **kw)
            wall[mode] = time.perf_counter() - t0
            n = tuple(a - b for a, b in zip(_k1_counts(k1), before))
            if n != (10, 10):
                _fail(f"[chaos] s={s} {mode}: K1 launched {n[0]} times, "
                      f"{n[1]} of them the forecast entry; expected 10 "
                      "forecast-entry launches")
            u = res[mode].utilities
            if u.shape != (N_JOBS, len(ahap)) or not np.isfinite(u).all():
                _fail(f"[chaos] s={s} {mode}: utilities {u.shape} not "
                      "finite")
        if not np.array_equal(res["collect"].mean_utility,
                              res["on"].mean_utility):
            _fail(f"[chaos] s={s}: collect=True changed the mean utilities")
        tel = res["collect"].sim_out
        for key in ("tel_fallback", "tel_pred_err", "tel_spot_cost",
                    "tel_progress"):
            if tel[key].shape != (N_JOBS, len(ahap), 10) or \
                    not np.isfinite(tel[key]).all():
                _fail(f"[chaos] s={s}: {key} {tel[key].shape} not finite "
                      f"of shape ({N_JOBS}, {len(ahap)}, 10)")
        fb = pool_ledger(tel, jobs, PAPER_TPUT)["fallback"]
        switches = selection_ledger(res["collect"])["top_policy"][
            "n_switches"]
        if not fb["events_reconciled"]:
            _fail(f"[chaos] s={s}: fallback events do not reconcile: {fb}")
        events = (fb["triggers"], fb["recoveries"], switches)
        if events != JAX_CHAOS[s]["events"]:
            _fail(f"[chaos] s={s}: (triggers, recoveries, switches) "
                  f"{events} != JAX {JAX_CHAOS[s]['events']}")
        for mode in ("off", "on"):
            r = res[mode]
            best, t_half, ratio, mean_u = JAX_CHAOS[s][mode]
            got_u = float(r.mean_utility[ahap].mean())
            if (r.best_policy(), r.iters_to_half()) != (best, t_half):
                _fail(f"[chaos] s={s} {mode}: best_policy/iters_to_half "
                      f"{(r.best_policy(), r.iters_to_half())} != JAX "
                      f"{(best, t_half)}")
            if abs(r.regret_ratio() - ratio) > REGRET_RTOL * ratio:
                _fail(f"[chaos] s={s} {mode}: regret_ratio "
                      f"{r.regret_ratio()} vs JAX {ratio}")
            if abs(got_u - mean_u) > MEAN_U_RTOL * abs(mean_u):
                _fail(f"[chaos] s={s} {mode}: AHAP mean utility {got_u} vs "
                      f"JAX {mean_u}")
            ahap_u[(s, mode)] = got_u
        print(f"[chaos] s={s} ({len(sched)} faults): prep {prep_s:.3f} s; "
              + "; ".join(f"{m} {wall[m]:.3f} s" for m, _ in modes)
              + f"; AHAP mean utility off {ahap_u[(s, 'off')]:.6f} on "
              f"{ahap_u[(s, 'on')]:.6f}; triggers {events[0]} recoveries "
              f"{events[1]} open {fb['open_at_end']} switches {events[2]}; "
              f"best {res['on'].best_policy()} regret_ratio off "
              f"{res['off'].regret_ratio():.6f} on "
              f"{res['on'].regret_ratio():.6f}; matches JAX")
    gain = ahap_u[(2, "on")] - ahap_u[(2, "off")]
    print(f"[chaos] fallback gain at s=2 (AHAP lanes' mean utility, on - "
          f"off): {gain:.6f}")
    return k1.window_dp_rows.launches, (pool, jobs, prices, avail, preds,
                                        cfg)


def _phase_grid(np, k1):
    """The scenario grid on the card: 48 regimes x 16 jobs, one
    ``simulate_and_select(collect=True)`` call per mu block. The winner map
    and the best fixed lane equal JAX_GRID; grid_ledger's residuals stay
    within RESIDUAL_BOUND; 20 forecast-entry K1 launches. Returns the K1
    launches."""
    from repro_torch import scenarios as sc
    from repro_torch.obs import grid_ledger

    specs, pool = _pool124()
    t0 = time.perf_counter()
    regimes = sc.grid_regimes()
    jobs, prices, avail, preds = sc.grid_inputs(regimes)
    prep_s = time.perf_counter() - t0
    k1.window_dp.launches = k1.window_dp_rows.launches = 0
    t0 = time.perf_counter()
    util, sim_out = sc.evaluate_grid(pool, regimes, jobs, prices, avail,
                                     preds, collect=True)
    wall = time.perf_counter() - t0
    if _k1_counts(k1) != (20, 20):
        _fail(f"[grid] K1 launched {_k1_counts(k1)} (all, forecast entry); "
              "expected 20 forecast-entry launches")
    if util.shape != (48, sc.GRID_JOBS, len(specs)) or \
            not np.isfinite(util).all():
        _fail(f"[grid] utilities {util.shape} not finite")
    winners, fixed = sc.grid_winners(util)
    if (tuple(winners.tolist()), fixed) != JAX_GRID:
        diff = [i for i, (a, b) in enumerate(zip(winners, JAX_GRID[0]))
                if a != b]
        _fail(f"[grid] winner map differs from JAX at regimes {diff}; best "
              f"fixed lane {fixed} vs {JAX_GRID[1]}")
    led = grid_ledger([{"key": r.key} for r in regimes], util, sim_out,
                      jobs, [r.tput for r in regimes], sc.GRID_JOBS,
                      lane_names=[p.name for p in specs])
    worst = (led["max_abs_cost_residual"], led["max_abs_utility_residual"])
    if max(worst) > RESIDUAL_BOUND:
        _fail(f"[grid] ledger residuals (cost, utility) {worst} above "
              f"{RESIDUAL_BOUND}")
    print(f"[grid] 48 regimes x {sc.GRID_JOBS} jobs x {len(specs)} lanes: "
          f"prep {prep_s:.3f} s, engine (2 calls, collect) {wall:.3f} s "
          f"({util.size / wall:.0f} cells/s); {len(set(winners.tolist()))} "
          f"distinct winners, best fixed lane {specs[fixed].name}; ledger "
          f"residuals cost {worst[0]:.3e} utility {worst[1]:.3e}; winner "
          "map matches JAX")
    return k1.window_dp_rows.launches


def _phase_trace_chaos(torch, engine, inp):
    """One traced chaos run (s = 2, monitor and recorder on): wall, device
    busy and idle share of the profiled wall, K1's share of busy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.workload import PAPER_TPUT

    pool, jobs, prices, avail, preds, cfg = inp
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.simulate_and_select(pool, jobs, PAPER_TPUT, prices, avail,
                                   preds, fallback=cfg, collect=True)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0:
        print(f"[trace] chaos: profiled wall {pwall:.4f} s; device time not "
              "measured (the profiler recorded no device events)")
        return
    k1_ev = [e for e in events if "window_dp" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1_ev) / 1e3
    print(f"[trace] chaos s=2, fallback and collect: profiled wall "
          f"{pwall:.4f} s; device busy {busy:.2f} ms = "
          f"{busy / (pwall * 1e3):.1%} (idle {1 - busy / (pwall * 1e3):.1%})"
          f"; K1 {k1_ms:.3f} ms ({k1_ms / busy:.1%} of busy, "
          f"{sum(e.count for e in k1_ev)} launches); "
          f"{sum(e.count for e in events)} device events")


def _region_workload(np):
    """benchmarks/region_e2e.py's workload, drawn as it draws it (seed 7:
    jobs, then window starts; per-job forecast seeds)."""
    from repro_torch import workload
    from repro_torch.core.region_market import vast_like_regions

    market = vast_like_regions(
        3, seed=13, days=8, phase_hours=(0.0, 8.0, 16.0), mean_price=0.7,
        price_sigma=0.5, avail_mean=5.5, avail_season_amp=3.0, delta_mig=1)
    rng = np.random.default_rng(SEED)
    jobs = workload.job_stream_arrays(rng, REGION_JOBS, REGION_SLOTS)
    t0s = rng.integers(0, len(market) - REGION_SLOTS - 1, size=REGION_JOBS)
    seeds = SEED * 100003 + np.arange(REGION_JOBS)
    return market, jobs, t0s, seeds


def _same_selection(a, b) -> bool:
    """Two SelectionResults select alike bit for bit: final EG state,
    trajectories and mean utilities."""
    import numpy as np

    return bool(a.state.weights.equal(b.state.weights)
                and np.array_equal(a.max_weight, b.max_weight)
                and np.array_equal(a.regret, b.regret)
                and np.array_equal(a.mean_utility, b.mean_utility))


def _phase_region(torch, np, engine, fast_sim, k1):
    """The regional selection path on the card at region_e2e.py's full
    size, flat and with REGION_P_OD: each once through a prep= closure (the
    side-stream double buffer; the timed run) and once from prebuilt
    arrays with collect=True (the same selection bit for bit, so prep=
    and the recorder change nothing; migrations reconciled across chunks);
    REGION_LAUNCHES forecast-entry K1 launches a run; JAX_REGION held. Then
    the prep / simulate / select split, the numpy and torch forecast stacks
    beside each other (the torch one's winner and regret against numpy's),
    and one traced run. Returns the forecast-entry launches of the checked
    runs."""
    from repro_torch.core.policy_pool import region_pool, specs_to_arrays
    from repro_torch.core import selector
    from repro_torch.obs import ledger
    from repro_torch.workload import PAPER_TPUT

    t_start = time.perf_counter()
    specs = region_pool()
    pool = specs_to_arrays(specs)
    market, jobs, t0s, seeds = _region_workload(np)
    kind, level = REGION_NOISE

    def prep(backend="numpy"):
        return lambda lo, hi: engine.prepare_noisy_inputs_regions(
            market, t0s[lo:hi], REGION_SLOTS, kind, level, seeds[lo:hi],
            prep_backend=backend)

    def run(p_od, arrays=None, **kw):
        args = arrays if arrays is not None else (None, None, None)
        return engine.simulate_and_select(
            pool, jobs, PAPER_TPUT, *args, delta_mig=market.delta_mig,
            p_od=p_od, job_chunk=REGION_CHUNK,
            prep=None if arrays is not None else prep(), **kw)

    run(None)                                   # warm-up
    arrays = prep()(0, REGION_JOBS)
    launches = 0
    walls = {}
    for name, p_od in (("flat", None), ("p_od", REGION_P_OD)):
        res = {}
        for mode, kw in (("prep", {}),
                         ("arrays", dict(collect=True, arrays=arrays))):
            before = _k1_counts(k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[mode] = run(p_od, **kw)
            walls[(name, mode)] = time.perf_counter() - t0
            n = tuple(a - b for a, b in zip(_k1_counts(k1), before))
            if n != (REGION_LAUNCHES, REGION_LAUNCHES):
                _fail(f"[region] {name} {mode}: K1 launched {n[0]} times, "
                      f"{n[1]} of them the forecast entry; expected "
                      f"{REGION_LAUNCHES} forecast-entry launches")
            launches += n[1]
        out = res["arrays"].sim_out
        u = out["utility"]
        if u.shape != (REGION_JOBS, len(specs)) or not np.isfinite(u).all():
            _fail(f"[region] {name}: utilities {u.shape} not finite")
        if not _same_selection(res["prep"], res["arrays"]):
            _fail(f"[region] {name}: prep= and the arrays (collect=True) "
                  "select differently; they must be bit-equal")
        recon = ledger.migration_reconciliation(out)
        if not (recon["events_reconciled"] and recon["series_matches_leaf"]):
            _fail(f"[region] {name}: migrations do not reconcile: {recon}")
        r = res["prep"]
        if name == "flat":
            flat = r
        best, t_half, ratio, migs = JAX_REGION[name]
        got = (r.best_policy(), r.iters_to_half(), recon["total_migrations"])
        if got != (best, t_half, migs):
            _fail(f"[region] {name}: (best, iters_to_half, migrations) {got} "
                  f"!= JAX {(best, t_half, migs)}")
        if abs(r.regret_ratio() - ratio) > REGRET_RTOL * ratio:
            _fail(f"[region] {name}: regret_ratio {r.regret_ratio()} vs JAX "
                  f"{ratio}")
        print(f"[region] {name}: {REGION_JOBS} jobs x {len(specs)} lanes x "
              f"{market.n_regions} regions x {REGION_SLOTS} slots, chunks of "
              f"{REGION_CHUNK}: engine with prep= {walls[(name, 'prep')]:.3f} "
              f"s ({REGION_JOBS * len(specs) / walls[(name, 'prep')]:.0f} "
              f"cells/s), arrays + collect {walls[(name, 'arrays')]:.3f} s; "
              f"best "
              f"{specs[r.best_policy()].name} iters_to_half {got[1]} "
              f"regret_ratio {r.regret_ratio():.6f} migrations {got[2]} "
              f"(mean {recon['migrations_mean']:.3f}, occupancy "
              + ", ".join(f"{o:.3f}" for o in recon["region_occupancy"])
              + f"); {REGION_LAUNCHES} K1 launches a run; matches JAX, "
              "prep= bit-equal to the arrays, migrations reconcile")

    # stage split (not double-buffered): prep, simulate, select, each
    # synchronized
    t0 = time.perf_counter()
    arrays = prep()(0, REGION_JOBS)
    prep_s = time.perf_counter() - t0
    dev = torch.device(DEVICE)
    jobs_d = fast_sim.jobs_to(jobs, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fast_sim.simulate_pool_regions(pool, jobs_d, PAPER_TPUT, *arrays,
                                         delta_mig=market.delta_mig)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine._normalize_and_scan(jobs_d, out["utility"],
                               selector.eg_init(len(specs), REGION_JOBS),
                               False)
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch_arrays = prep("torch")(0, REGION_JOBS)
    torch.cuda.synchronize()
    torch_prep_s = time.perf_counter() - t0
    print(f"[split] region flat: prep (numpy, {REGION_JOBS} jobs x "
          f"{market.n_regions} regions) {prep_s:.4f} s, simulate (unchunked) "
          f"{sim_s:.4f} s, select {sel_s:.4f} s; forecast stack on the card "
          f"(one batched counter-based draw) {torch_prep_s:.4f} s against "
          f"numpy {prep_s:.4f} s")
    r_t = run(None, arrays=torch_arrays)
    if r_t.best_policy() != flat.best_policy() or abs(
            r_t.regret_ratio() - flat.regret_ratio()) > TORCH_PREP_REGRET_ATOL:
        _fail(f"[region] torch-drawn forecasts: best {r_t.best_policy()} "
              f"regret_ratio {r_t.regret_ratio()} against numpy's "
              f"{flat.best_policy()} {flat.regret_ratio()}")
    print(f"[region] torch-drawn forecasts: best {r_t.best_policy()} "
          f"regret_ratio {r_t.regret_ratio():.6f} (numpy "
          f"{flat.regret_ratio():.6f}); same winner")

    # device activity alone: a run is ~57,000 device events, and the
    # host-side op events would multiply the profiler's own work
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run(None)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    events = _device_events(prof)
    trace_s = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0:
        print(f"[trace] region: profiled wall {pwall:.4f} s; device time not "
              "measured (the profiler recorded no device events)")
        return launches
    k1_ev = [e for e in events if "window_dp" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1_ev) / 1e3
    copies = [e for e in events if "Memcpy HtoD" in e.key]
    print(f"[trace] region flat (prep=, 4 chunks): profiled wall "
          f"{pwall:.4f} s; device busy {busy:.2f} ms = "
          f"{busy / (pwall * 1e3):.1%} (idle {1 - busy / (pwall * 1e3):.1%})"
          f"; K1 {k1_ms:.3f} ms ({k1_ms / busy:.1%} of busy, "
          f"{sum(e.count for e in k1_ev)} launches); host-to-device copies "
          f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms "
          f"({sum(e.count for e in copies)}); "
          f"{sum(e.count for e in events)} device events; the trace took "
          f"{trace_s:.1f} s, the phase {time.perf_counter() - t_start:.1f} s")
    return launches


def _phase_oracle(torch, np, engine, fast_sim, k1, fig9_inputs):
    """The host reference chain on the card: for ORACLE_JOBS jobs, every
    region_pool lane of the [region] workload through the python regional
    simulator (simulate_regional with the lane's build() /
    build_selector(); AHAP's windows on K1's table entry) against
    simulate_pool_regions, and every paper_pool lane of the first Fig. 9
    setting through simulator.simulate against simulate_pool_jobs; the
    offline optimum above every lane. Returns (forecast-entry launches,
    table-entry launches)."""
    from repro_torch.core import offline_opt, simulator
    from repro_torch.core.market import from_arrays
    from repro_torch.core.policy_pool import (paper_pool, region_pool,
                                              specs_to_arrays)
    from repro_torch.core.region_market import simulate_regional
    from repro_torch.workload import PAPER_TPUT

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    k1.window_dp.launches = k1.window_dp_rows.launches = 0
    n = ORACLE_JOBS

    def check(what, got_u, want):
        for key in ("n_spot", "n_od"):
            if not np.array_equal(got_u[key], getattr(want, key)):
                _fail(f"[oracle] {what}: {key} {got_u[key].tolist()} != the "
                      f"python oracle's {getattr(want, key).tolist()}")
        if abs(got_u["utility"] - want.utility) > (
                ORACLE_ATOL + ORACLE_RTOL * abs(want.utility)):
            _fail(f"[oracle] {what}: utility {got_u['utility']} vs the "
                  f"python oracle's {want.utility}")

    # region lanes
    market, jobs, t0s, seeds = _region_workload(np)
    kind, level = REGION_NOISE
    rp, ra, rpm = engine.prepare_noisy_inputs_regions(
        market, t0s[:n], REGION_SLOTS, kind, level, seeds[:n])
    sub = fast_sim.slice_jobs(jobs, 0, n)
    specs = region_pool()
    out = fast_sim.simulate_pool_regions(
        specs_to_arrays(specs), sub, PAPER_TPUT, rp, ra, rpm,
        delta_mig=market.delta_mig)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    n_region = 0
    for k, job in enumerate(fast_sim.unstack_jobs(sub)):
        w = market.window(int(t0s[k]), REGION_SLOTS)
        for i, spec in enumerate(specs):
            ref = simulate_regional(spec.build(device=dev),
                                    spec.build_selector(), job, PAPER_TPUT,
                                    w, rpm[k])
            what = f"job {k} {spec.name}"
            check(what, {key: out[key][k, i] for key in
                         ("n_spot", "n_od", "utility")}, ref)
            done_at = len(ref.region_hist)
            if ref.completed_by_deadline:
                done_at = int(np.ceil(ref.completion_time))
            if ref.migrations != int(out["migrations"][k, i]) or not \
                    np.array_equal(out["region"][k, i, :done_at],
                                   ref.region_hist[:done_at]):
                _fail(f"[oracle] {what}: region path / migrations differ "
                      "from the python oracle's")
            n_region += 1
    region_counts = _k1_counts(k1)

    # single-region paper_pool lanes, and the offline optimum
    jobs9, prices, avail, preds = fig9_inputs
    sub = fast_sim.slice_jobs(jobs9, 0, n)
    specs = paper_pool()
    out = fast_sim.simulate_pool_jobs(specs_to_arrays(specs), sub,
                                      PAPER_TPUT, prices[:n], avail[:n],
                                      preds[:n])
    out = {k: v.cpu().numpy() for k, v in out.items()}
    gaps = []
    for k, job in enumerate(fast_sim.unstack_jobs(sub)):
        trace = from_arrays(prices[k], avail[k])
        for i, spec in enumerate(specs):
            ref = simulator.simulate(spec.build(device=dev), job, PAPER_TPUT,
                                     trace, preds[k] if spec.kind == 0
                                     else None)
            check(f"Fig. 9 job {k} {spec.name}",
                  {key: out[key][k, i] for key in
                   ("n_spot", "n_od", "utility")}, ref)
        opt = offline_opt.solve_offline(job, PAPER_TPUT, trace)
        best = float(out["utility"][k].max())
        if best > opt.utility + 1e-3:
            _fail(f"[oracle] Fig. 9 job {k}: a lane's utility {best} beats "
                  f"the offline optimum {opt.utility}")
        gaps.append(opt.utility - best)
    counts = _k1_counts(k1)
    table = counts[0] - counts[1]
    wall = time.perf_counter() - t_start
    print(f"[oracle] {n} jobs: {n_region} regional (job, lane) runs of "
          f"simulate_regional and {n * len(specs)} of simulator.simulate "
          f"equal the vectorized lanes on the card (allocations, region "
          f"paths, migrations exact; utilities to {ORACLE_RTOL:g} / "
          f"{ORACLE_ATOL:g}); offline optimum above every lane (gap to the "
          f"best lane {min(gaps):.4f}-{max(gaps):.4f}); K1 launches: "
          f"{table} table entry (python AHAP decisions; "
          f"{region_counts[0] - region_counts[1]} of them regional), "
          f"{counts[1]} forecast entry; {wall:.2f} s")
    return counts[1], table


def _fleet_workload(np, engine, arrs):
    """benchmarks/fleet_sim.py's workload, drawn as its ``_workload`` draws
    it (tools/jax_fleet_refs.py's ``workload``): (trace, prices, avail,
    pred, arrivals, pilot SelectionResult, rows, idx, generator)."""
    from repro_torch.core import fast_sim
    from repro_torch.core.predictor import NoisyPredictor
    from repro_torch.workload import (PAPER_TPUT, job_stream_arrays,
                                      paper_market)

    kind, level = FLEET_NOISE
    rng = np.random.default_rng(FLEET_SEED)
    trace = paper_market(seed=29, days=3).window(0, FLEET_SLOTS + 1)
    pred = NoisyPredictor(trace, kind, level, seed=FLEET_SEED).matrix(
        fast_sim.W1MAX - 1)[:FLEET_SLOTS].astype(np.float32)
    prices = trace.prices[:FLEET_SLOTS].astype(np.float32)
    avail = trace.avail[:FLEET_SLOTS].astype(np.int64)
    arrivals = rng.integers(0, FLEET_SPAN, size=FLEET_JOBS)
    pilot_trace = paper_market(seed=31, days=40)
    pilot_jobs = job_stream_arrays(rng, FLEET_PILOT, FLEET_DEADLINE)
    t0s = rng.integers(0, len(pilot_trace) - FLEET_DEADLINE - 1,
                       size=FLEET_PILOT)
    seeds = FLEET_SEED * 100003 + np.arange(FLEET_PILOT)
    res = engine.simulate_and_select(
        arrs, pilot_jobs, PAPER_TPUT,
        *engine.prepare_noisy_inputs(pilot_trace, t0s, FLEET_DEADLINE, kind,
                                     level, seeds))
    rows, idx = res.admission_rows(arrs, FLEET_JOBS, rng=rng)
    return trace, prices, avail, pred, arrivals, res, rows, idx


def _fleet_summary(np, idx, out, n_pol):
    """tools/jax_fleet_refs.py's ``summary``: (bincount of the admitted
    lanes, their CRC32, per-slot spot grants, jobs finished by the
    deadline, sum of the utilities)."""
    import zlib

    idx = np.asarray(idx, np.int32)
    host = {k: out[k].cpu().numpy() for k in ("n_spot", "completed",
                                               "utility")}
    return (tuple(int(c) for c in np.bincount(idx, minlength=n_pol)),
            zlib.crc32(idx.tobytes()),
            tuple(int(g) for g in host["n_spot"].sum(axis=0)),
            int(host["completed"].sum()),
            float(host["utility"].astype(np.float64).sum()))


def _check_fleet(name, got, want):
    """A fleet summary against JAX_FLEET: everything exact but the utility
    sum (FLEET_USUM_RTOL)."""
    labels = ("admitted lanes' bincount", "admitted lanes' CRC32",
              "per-slot spot grants", "jobs finished by the deadline")
    for label, g, w in zip(labels, got[:4], want[:4]):
        if g != w:
            _fail(f"[fleet] {name}: {label} {g} != JAX {w}")
    if abs(got[4] - want[4]) > FLEET_USUM_RTOL * abs(want[4]):
        _fail(f"[fleet] {name}: utility sum {got[4]} vs JAX {want[4]}")


def _phase_fleet(torch, np, engine, fast_sim, window_opt, k1,
                 window_dp_rows_ref):
    """Fleet contention on the card at benchmarks/fleet_sim.py's full size:
    the EG pilot, the select -> admit loop, then simulate_fleet on the
    card: FLEET_SLOTS forecast-entry K1 launches a call; bit-equal to the
    backend="torch" run on the card (every slot's real K1 rows captured
    there and held bit for bit, past-deadline and pre-arrival rows among
    them); JAX_FLEET held for sampled and greedy admission; collect=True
    (fleet_ledger: no slot granted above its supply) and the monitor armed
    once; the port's MultiJobScheduler on the card (each python AHAP
    window on K1's table entry) matching every job to FLEET_ORACLE_ATOL;
    one engine call traced. Returns (forecast-entry launches, table-entry
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.chaos import FallbackConfig
    from repro_torch.core import fleet, policies
    from repro_torch.core.multi_job import MultiJobScheduler
    from repro_torch.obs import fleet_ledger
    from repro_torch.workload import PAPER_JOB, PAPER_TPUT

    t_start = time.perf_counter()
    specs, arrs = _pool124()
    n_pol = len(specs)
    c0 = _k1_counts(k1)
    t0 = time.perf_counter()
    trace, prices, avail, pred, arrivals, res, rows, idx = _fleet_workload(
        np, engine, arrs)
    pilot_s = time.perf_counter() - t0
    got = (res.best_policy(), res.iters_to_half())
    if got != JAX_FLEET["pilot"]:
        _fail(f"[fleet] pilot (best, iters_to_half) {got} != JAX "
              f"{JAX_FLEET['pilot']}")
    jobs = fast_sim.stack_jobs([PAPER_JOB] * FLEET_JOBS)

    def run(rows_=rows, **kw):
        return fleet.simulate_fleet(rows_, jobs, arrivals, PAPER_TPUT, prices,
                                    avail, pred, **kw)

    def counted(what, fn):
        before = _k1_counts(k1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(_k1_counts(k1), before))
        if n != (FLEET_SLOTS, FLEET_SLOTS):
            _fail(f"[fleet] {what}: K1 launched {n[0]} times, {n[1]} of "
                  f"them the forecast entry; expected {FLEET_SLOTS} "
                  "forecast-entry launches (one a slot)")
        return out, wall

    run()                                                   # warm-up
    out, engine_s = counted("engine", run)
    engine_s2 = counted("engine", run)[1]
    summary = _fleet_summary(np, idx, out, n_pol)
    _check_fleet("sampled admission", summary, JAX_FLEET["sampled"])
    kinds = np.bincount(np.asarray(rows["kind"]), minlength=6)

    # the plain chain on the card, every slot's real rows captured
    captured = []
    plain_rows = window_opt._solve_rows

    def capture(job, tput, z0, std, p, a, tn, backend):
        captured.append((
            type(job)(**{f: getattr(job, f).clone()
                         for f in job.__dataclass_fields__}),
            z0.clone(), std.clone(), p.clone(), a.clone()))
        return plain_rows(job, tput, z0, std, p, a, tn, backend)

    window_opt._solve_rows = capture
    try:
        t0 = time.perf_counter()
        plain = run(backend="torch")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        window_opt._solve_rows = plain_rows
    for key in out:
        if not torch.equal(out[key], plain[key]):
            _fail(f"[fleet] {key} of the K1 run differs from the plain-DP "
                  "run on the card; they must be bit-equal")
    if len(captured) != FLEET_SLOTS:
        _fail(f"[fleet] captured {len(captured)} slots of K1 rows, expected "
              f"{FLEET_SLOTS}")
    past = pre = 0
    arr_ahap = arrivals[np.asarray(rows["kind"]) == 0]
    for slot, rows_t in enumerate(captured):
        past += int((rows_t[2] <= 0).sum())
        pre += int((arr_ahap > slot).sum())
        _compare_k1_rows(f"fleet slot {slot} real rows", rows_t, PAPER_TPUT,
                         TN, torch, k1, window_dp_rows_ref)
    ahap_rows = captured[0][1].shape[0]
    print(f"[fleet] K1 on the fleet's real rows: {FLEET_SLOTS} slots x "
          f"{ahap_rows} AHAP jobs bit-equal to the plain chain, "
          f"{pre} rows before their job's arrival and {past} past its "
          "deadline (eff_slots <= 0) among them")

    # the recorder and the monitor
    tel, _ = counted("collect", lambda: run(collect=True))
    for key in out:
        if not torch.equal(out[key], tel[key]):
            _fail(f"[fleet] collect=True changed {key}")
    ledger = fleet_ledger({k: v.cpu().numpy() for k, v in tel.items()},
                          jobs, PAPER_TPUT, supply=avail)
    over = ledger["waterfall"]["max_oversubscription"]
    grants = tel["tel_grant"].sum(dim=0).cpu().numpy()
    if over > 0 or (grants > avail).any():
        _fail(f"[fleet] a slot granted above its supply: grants "
              f"{grants.tolist()}, supply {avail.tolist()}")
    fb, fb_s = counted("fallback", lambda: run(
        collect=True, fallback=FallbackConfig(0.5, lam=0.5)))
    if not bool(torch.isfinite(fb["utility"]).all()):
        _fail("[fleet] non-finite utilities with the monitor armed")

    # greedy admission
    rows_g, idx_g = res.admission_rows(arrs, FLEET_JOBS, greedy=True)
    out_g, greedy_s = counted("greedy", lambda: run(rows_g))
    _check_fleet("greedy admission", _fleet_summary(np, idx_g, out_g, n_pol),
                 JAX_FLEET["greedy"])

    # the host oracle on the card: each python AHAP window solve is one
    # launch of K1's table entry
    solves = [0]
    solve = policies.solve_window_numpy

    def count_solve(*args, **kwargs):
        solves[0] += 1
        return solve(*args, **kwargs)

    before = _k1_counts(k1)
    policies.solve_window_numpy = count_solve
    try:
        t0 = time.perf_counter()
        sched = MultiJobScheduler(PAPER_TPUT, trace)
        for i in range(FLEET_JOBS):
            sched.submit(int(arrivals[i]), PAPER_JOB,
                         specs[int(idx[i])].build(), pred=pred)
        done = {r.job_id: r for r in sched.run(FLEET_SLOTS)}
        oracle_s = time.perf_counter() - t0
    finally:
        policies.solve_window_numpy = solve
    n = tuple(a - b for a, b in zip(_k1_counts(k1), before))
    table = n[0] - n[1]
    if n[1] != 0 or table != solves[0] or table == 0:
        _fail(f"[fleet] oracle: {table} table-entry and {n[1]} "
              f"forecast-entry launches for {solves[0]} python-AHAP window "
              "solves; expected one table-entry launch a solve")
    u_loop = np.array([done[i].utility for i in range(FLEET_JOBS)])
    u_dev = out["utility"].cpu().numpy().astype(np.float64)
    diff = np.abs(u_dev - u_loop)
    match = float(np.mean(diff <= FLEET_ORACLE_ATOL))
    if match != 1.0:
        bad = int(np.argmax(diff > FLEET_ORACLE_ATOL))
        _fail(f"[fleet] engine and MultiJobScheduler differ on "
              f"{int((diff > FLEET_ORACLE_ATOL).sum())} jobs (first: job "
              f"{bad}, {u_dev[bad]} vs {u_loop[bad]})")

    # one engine call traced
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    k1_ev = [e for e in events if "window_dp" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1_ev) / 1e3
    launches = _k1_counts(k1)[1] - c0[1]
    table_all = (_k1_counts(k1)[0] - c0[0]) - launches
    print(f"[fleet] pilot ({FLEET_PILOT} jobs x {n_pol} lanes) and "
          f"admission {pilot_s:.3f} s: best={JAX_FLEET['pilot'][0]} "
          f"iters_to_half={JAX_FLEET['pilot'][1]}; {FLEET_JOBS} jobs admitted "
          f"(kinds 0-5: {kinds.tolist()}), the same lanes as JAX (CRC32 "
          f"{summary[1]})")
    print(f"[fleet] simulate_fleet on the card: {FLEET_JOBS} jobs x "
          f"{FLEET_SLOTS} slots, {engine_s:.4f} / {engine_s2:.4f} s a call "
          f"({FLEET_JOBS / engine_s:.0f} jobs/s), {FLEET_SLOTS} K1 "
          f"forecast-entry launches a call at B = {ahap_rows}; plain DP on "
          f"the card {plain_s:.4f} s (bit-equal); collect bit-equal, max "
          f"oversubscription {over}, starvation incidence "
          f"{ledger['waterfall']['starvation_incidence']:.3f}; monitor "
          f"armed {fb_s:.4f} s, {int(fb['tel_fallback'].sum())} fallback "
          f"job-slots; greedy {greedy_s:.4f} s; JAX_FLEET held (spot "
          f"grants a slot {list(summary[2])}, {summary[3]} finished by the "
          f"deadline, utility sum {summary[4]:.6f} against "
          f"{JAX_FLEET['sampled'][4]:.6f})")
    print(f"[fleet] MultiJobScheduler on the card (python policies, each "
          f"AHAP window on K1's table entry): {oracle_s:.3f} s, "
          f"{table} table-entry launches for {solves[0]} window solves "
          f"({oracle_s / max(table, 1) * 1e3:.3f} ms of host wall a solve); "
          f"utility match {match:.3f} (max |diff| {diff.max():.3e}, atol "
          f"{FLEET_ORACLE_ATOL}); the oracle takes "
          f"{oracle_s / engine_s:.1f}x the engine's wall")
    if busy == 0:
        print(f"[trace] fleet: profiled wall {pwall:.4f} s; device time not "
              "measured (the profiler recorded no device events)")
    else:
        print(f"[trace] fleet engine call: profiled wall {pwall:.4f} s; "
              f"device busy {busy:.2f} ms = {busy / (pwall * 1e3):.1%} (idle "
              f"{1 - busy / (pwall * 1e3):.1%}); K1 {k1_ms:.3f} ms "
              f"({k1_ms / busy:.1%} of busy, "
              f"{sum(e.count for e in k1_ev)} launches); "
              f"{sum(e.count for e in events)} device events")
    print(f"[fleet] phase {time.perf_counter() - t_start:.1f} s")
    return launches, table_all


def _phase_time_k1_region(torch, k1, tput, window_dp_ref,
                          window_dp_rows_ref, clock):
    """K1 at the shapes this slice launches it with: the forecast entry at
    B = 18 AHAP lanes x REGION_CHUNK jobs (the regional scan's rows a slot,
    random rows) and the table entry at B = 1 (one python-AHAP window,
    (w1, tn) = (4, 12)), each 25 launches in a CUDA graph beside its plain
    version (events) and its bound; and the host wall of one
    ``solve_window_numpy`` call (table in torch ops, K1, the plan back to
    the host). Timing launches do not count."""
    from repro_torch.configs.base import JobConfig
    from repro_torch.core import window_opt

    launches = (k1.window_dp.launches, k1.window_dp_rows.launches)
    dev = torch.device(DEVICE)
    b = 18 * REGION_CHUNK
    rows = _forecast_rows(b, W1, TN, 2027, torch, dev)
    fn = lambda: k1.window_dp_rows(rows[0], tput, *rows[1:], TN)
    ms = _graph_ms(torch, fn)
    plain = _event_ms(torch, lambda: window_dp_rows_ref(rows[0], tput,
                                                        *rows[1:], TN), 5)
    row_bytes = 4 * (2 * W1 + 2 + 7 + 2 * W1 + 1)
    bound, b_ms, o_ms, _, _ = _k1_bound(b, W1, TN, row_bytes, clock)
    out = {"forecast": {"B": b, "w1": W1, "tn": TN, "ms": ms,
                        "plain_ms": plain, "bound_ms": bound,
                        "bound_by": _bound_by(b_ms, o_ms)}}
    job = JobConfig(workload=80.0, deadline=10, n_min=1, n_max=12,
                    value=120.0)
    z0, std, prices, avail = 31.5, 4, [0.4, 0.9, 0.55, 1.2], [5, 2, 9, 0]
    args = (job, tput, z0, std, prices, avail, 1.0)
    c, _, g = window_opt._unit_cost_table(
        job, tput, torch.tensor([z0], device=dev),
        torch.tensor([std], dtype=torch.int32, device=dev),
        torch.tensor([prices], device=dev),
        torch.tensor([avail], dtype=torch.int32, device=dev), 1.0, 12)
    _compare_k1("a python AHAP window's table", c, g, torch, k1.window_dp,
                window_dp_ref)
    ms = _graph_ms(torch, lambda: k1.window_dp(c, g))
    plain = _event_ms(torch, lambda: window_dp_ref(c, g), TIME_REPS)
    w1, tn = len(prices), 12
    row_bytes = 4 * (w1 * (tn + 1) + w1 * tn + 1 + w1 + 1)
    bound, b_ms, o_ms, _, _ = _k1_bound(1, w1, tn, row_bytes, clock)
    for _ in range(20):
        window_opt.solve_window_numpy(*args)
    t0 = time.perf_counter()
    for _ in range(200):
        window_opt.solve_window_numpy(*args)
    call_ms = (time.perf_counter() - t0) / 200 * 1e3
    out["table"] = {"B": 1, "w1": w1, "tn": tn, "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": _bound_by(b_ms, o_ms),
                    "call_ms": call_ms}
    k1.window_dp.launches, k1.window_dp_rows.launches = launches
    return out


# ---------------------------------------------------------------------------
# Dense-model serving: K2, K3 and the serving path
# ---------------------------------------------------------------------------

def _randn(torch, gen, shape, std, dtype):
    """A normal draw made on the card from ``gen``, scaled, then cast."""
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(
        dtype)


def _close(torch, what, got, want, rtol, atol, scale=None) -> float:
    """got against want in f32, elementwise |got - want| <= atol + rtol
    |want| (rtol ``scale`` where given: for a sum of rounded terms, the sum
    of the terms' magnitudes); returns the largest |got - want|."""
    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        _fail(f"{what}: shape {tuple(g.shape)} vs {tuple(w.shape)} or "
              "non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * (w.abs() if scale is None else scale)
    if bool(bad.any()):
        _fail(f"{what}: {int(bad.sum())} of {err.numel()} elements outside "
              f"rtol {rtol} atol {atol} (max |err| {float(err.max()):.3e})")
    return float(err.max())


def _lora_case(torch, gen, m, k, n, r, dtype):
    return (_randn(torch, gen, (m, k), 1.0, dtype),
            _randn(torch, gen, (k, n), 0.05, dtype),
            _randn(torch, gen, (k, r), 0.05, dtype),
            _randn(torch, gen, (r, n), 0.05, dtype))


def _phase_k2(torch, gen, k2, lora_matmul_ref) -> float:
    """K2 against its plain version on the card: the JAX package's kernel
    test shapes at f32 and bf16, a ragged shape, the edges of the bf16
    tiles, the serving shapes (prefill and decode of llama2-7b's q / v,
    mamba2-370m's and zamba2-2.7b's wx, mixtral-8x7b's q and v) and the
    training paths' (qwen2-vl-7b's q and v, hubert-xlarge's, mixtral's)."""
    cases = [((m, k, n, r), dt)
             for m, k, n, r in ((128, 128, 128, 16), (256, 384, 128, 8),
                                (128, 256, 256, 64))
             for dt in ("float32", "bfloat16")]
    cases += [((200, 4096, 4096, 16), "float32"),
              ((200, 4096, 4096, 16), "bfloat16")]
    # the edges of the bf16 tiles: decode (M <= 64) and prefill (128 x 256,
    # BK 64), K and N off the tile, N 4100 with a ragged row pitch
    cases += [((m, 4104, 4100, r), "bfloat16") for m in (1, 8, 17, 64, 65, 200)
              for r in (8, 16, 64)]
    # the serving and training paths' shapes (M, K, N)
    cases += [((m, k, n, 16), "bfloat16") for m, k, n in dict.fromkeys(
        row[:3] for row in _k2_shapes(None).values())]
    max_err = 0.0
    for (m, k, n, r), dt in cases:
        x, w, a, b = _lora_case(torch, gen, m, k, n, r, getattr(torch, dt))
        launches = k2.lora_matmul.launches
        y = k2.lora_matmul(x, w, a, b, 2.0)
        torch.cuda.synchronize()
        k2.lora_matmul.launches = launches  # comparison launches do not count
        want = lora_matmul_ref(x, w, a, b, 2.0)
        err = _close(torch, f"K2 {dt} {(m, k, n, r)}", y, want,
                     *K2_TOL[dt])
        max_err = max(max_err, err)
        print(f"[k2] {dt} (M, K, N, r) = {(m, k, n, r)}: max |err| "
              f"{err:.3e} within rtol/atol {K2_TOL[dt]}")
    return max_err


def _phase_k3(torch, gen, k3, flash_attention_ref) -> float:
    """K3 against its plain version on the card: the JAX package's kernel
    test shapes and masks, bf16, a ragged S, llama2-7b's, mixtral-8x7b's
    and DENSE_RUNS' prefills, head dim 80 up to zamba2-2.7b's prefill, and
    the edges of the bf16 tiles."""
    from repro_torch.configs import get_config

    cases = [((bh, sq, sk, d), "float32", causal, window)
             for bh, sq, sk, d in ((4, 256, 256, 64), (2, 128, 512, 128))
             for causal, window in ((True, None), (False, None), (True, 100))]
    cases += [((2, 128, 128, 64), "bfloat16", True, None),
              ((3, 200, 200, 128), "bfloat16", True, None),
              ((3, 200, 200, 128), "float32", True, 37),
              ((SERVE_BATCH * 32, SERVE_PROMPT, SERVE_PROMPT, 128),
               "bfloat16", True, None),
              # mixtral-8x7b's prefill: its window (4096) is past S
              ((MOE_RUN[1] * 32, MOE_RUN[2], MOE_RUN[2], 128), "bfloat16",
               True, 4096)]
    # DENSE_RUNS' prefills (D 128; mixtral-8x22b's window 4096 past S)
    cases += [((SERVE_BATCH * c.num_heads, SERVE_PROMPT, SERVE_PROMPT,
                c.head_dim), "bfloat16", True, c.sliding_window)
              for c in (get_config(run[0]) for run in DENSE_RUNS.values())]
    # head_dim 80 (zamba2-2.7b's shared block), up to its prefill shape
    cases += [((4, 256, 256, 80), "float32", True, None),
              ((2, 128, 300, 80), "float32", False, None),
              ((3, 200, 200, 80), "bfloat16", True, 37),
              ((SERVE_BATCH * 32, 1024, 1024, 80), "bfloat16", True, None)]
    # the edges of the bf16 tiles (64 query rows, 64 keys): S around a tile,
    # Sq = Sk and Sq < Sk, each head dim, causal, with and without a window
    cases += [((2, s, s + extra, d), "bfloat16", True, window)
              for s in (1, 63, 65, 127, 129, 200) for extra in (0, 50)
              for d in (64, 80, 128) for window in (None, 37)]
    max_err = 0.0
    for (bh, sq, sk, d), dt, causal, window in cases:
        dtype = getattr(torch, dt)
        q = _randn(torch, gen, (bh, sq, d), 1.0, dtype)
        k = _randn(torch, gen, (bh, sk, d), 1.0, dtype)
        v = _randn(torch, gen, (bh, sk, d), 1.0, dtype)
        launches = k3.flash_attention.launches
        o = k3.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        k3.flash_attention.launches = launches
        want = flash_attention_ref(q[None], k[None], v[None], causal=causal,
                                   window=window)[0]
        what = (f"{dt} (BH, Sq, Sk, D) = {(bh, sq, sk, d)} causal={causal} "
                f"window={window}")
        err = _close(torch, f"K3 {what}", o, want, *K3_TOL[dt])
        max_err = max(max_err, err)
        print(f"[k3] {what}: max |err| {err:.3e} within rtol/atol "
              f"{K3_TOL[dt]}")
    return max_err


def _ssd_case(torch, gen, bh, s, p, n, dtype):
    """K4 inputs drawn as the JAX kernel test draws them: x ~ N(0, 1),
    dt = softplus(N(0, 1)) / 2, A = -exp(N(0, 1)) / 2, B, C ~ 0.3 N(0, 1);
    dt and A f32."""
    dt = torch.nn.functional.softplus(
        torch.randn((bh, s), generator=gen, device=gen.device)) * 0.5
    a = -torch.exp(torch.randn((bh,), generator=gen, device=gen.device)) * 0.5
    return (_randn(torch, gen, (bh, s, p), 1.0, dtype), dt, a,
            _randn(torch, gen, (bh, s, n), 0.3, dtype),
            _randn(torch, gen, (bh, s, n), 0.3, dtype))


def _ssd_layout(arch, batch, seq):
    """K4's (Bt, S, H, P, G, N) in ``arch``'s layer at (batch, seq)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    sc = cfg.ssm
    return (batch, seq, sc.heads(cfg.d_model), sc.head_dim, sc.n_groups,
            sc.state_size)


def _ssd_layouts():
    """K4 on the two full-width prefills, in the model's layout: tag ->
    (Bt, S, H, P, G, N)."""
    return {tag: _ssd_layout(arch, batch, prompt)
            for tag, (arch, batch, prompt, _, _) in FAMILY_RUNS.items()}


def _ssd_grouped_case(torch, gen, bt, s, hh, p, g, n, dtype):
    """K4's grouped inputs as the Mamba2 layer holds them: x (Bt, S, H, P)
    and B, C (Bt, S, G, N) strided views of one (Bt, S, H P + 2 G N) buffer
    (x ~ N(0, 1), B, C ~ 0.3 N(0, 1)), dt (Bt, S, H) = softplus(N(0, 1)) / 2
    and A (H,) = -exp(N(0, 1)) / 2 in f32; all drawn on the card."""
    di = hh * p
    xbc = torch.cat([_randn(torch, gen, (bt, s, di), 1.0, dtype),
                     _randn(torch, gen, (bt, s, 2 * g * n), 0.3, dtype)], -1)
    dt = torch.nn.functional.softplus(
        torch.randn((bt, s, hh), generator=gen, device=gen.device)) * 0.5
    a = -torch.exp(torch.randn((hh,), generator=gen, device=gen.device)) * 0.5
    return (xbc[..., :di].reshape(bt, s, hh, p), dt, a,
            xbc[..., di:di + g * n].reshape(bt, s, g, n),
            xbc[..., di + g * n:].reshape(bt, s, g, n))


def _flattened(torch, x, dt, a, B, C):
    """The grouped operands as the TPU kernel's flattened layout:
    contiguous (Bt*H, ...) copies with B and C repeated to heads."""
    bt, s, hh, p = x.shape
    rep = hh // B.shape[2]
    B, C = (t.repeat_interleave(rep, dim=2) for t in (B, C))

    def flat(t):
        return t.transpose(1, 2).reshape(bt * hh, s, -1).contiguous()

    return (flat(x), dt.transpose(1, 2).reshape(bt * hh, s).contiguous(),
            a.repeat(bt), flat(B), flat(C))


def _check_k4(torch, what, y, h, want_y, want_h, dtype) -> float:
    dt = str(dtype).split(".")[-1]
    err = _close(torch, f"K4 y {what}", y, want_y, *K4_TOL[dt])
    err_h = _close(torch, f"K4 state {what}", h, want_h, *K4_TOL["float32"])
    if y.dtype != dtype or h.dtype != torch.float32:
        _fail(f"K4 {what}: y {y.dtype}, state {h.dtype}")
    print(f"[k4] {what}: max |err| y {err:.3e} within rtol/atol "
          f"{K4_TOL[dt]}, state {err_h:.3e} within {K4_TOL['float32']}")
    return max(err, err_h)


def _phase_k4(torch, gen, k4, ssd_scan_ref, ssd_scan_grouped_ref) -> float:
    """K4 against its plain version on the card, f32 and bf16. Flattened
    layout: the JAX package's kernel test shapes, two ragged S, and
    mamba2-370m's and zamba2-2.7b's prefill shapes. The model's layout
    (strided views of one buffer, B and C per group): both serving layouts
    at full size, also bit-equal to the flattened entry on copies; the
    smoke configs' layout (rows of 544 elements); two groups; S at the
    64-step chunk edges."""
    shapes = [(4, 256, 64, 32), (2, 256, 32, 128), (3, 200, 64, 16),
              (2, 37, 32, 64)] + [(bt * hh, s, p, n) for bt, s, hh, p, _, n
                                  in _ssd_layouts().values()]
    max_err = 0.0
    launches = k4.ssd_scan.launches    # comparison launches do not count
    for bh, s, p, n in shapes:
        for dt in ("float32", "bfloat16"):
            ins = _ssd_case(torch, gen, bh, s, p, n, getattr(torch, dt))
            y, h = k4.ssd_scan(*ins)
            torch.cuda.synchronize()
            want_y, want_h = ssd_scan_ref(*ins)
            max_err = max(max_err, _check_k4(
                torch, f"{dt} (BH, S, P, N) = {(bh, s, p, n)}", y, h, want_y,
                want_h, ins[0].dtype))
    grouped = [(lay, True) for lay in _ssd_layouts().values()]
    grouped += [((3, 300, 16, 32, 1, 16), False),   # the smoke configs'
                ((2, 300, 8, 64, 2, 64), False)]
    grouped += [((2, s, 4, 64, 1, 128), False) for s in (1, 63, 64, 65, 2049)]
    for (bt, s, hh, p, g, n), flat in grouped:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            ins = _ssd_grouped_case(torch, gen, bt, s, hh, p, g, n, dtype)
            y, h = k4.ssd_scan_grouped(*ins)
            torch.cuda.synchronize()
            what = (f"{dt} grouped (Bt, S, H, P, G, N) = "
                    f"{(bt, s, hh, p, g, n)}, row stride {ins[0].stride(1)}")
            if flat:
                yf, hf = k4.ssd_scan(*_flattened(torch, *ins))
                if not (torch.equal(yf.reshape(bt, hh, s, p).transpose(1, 2),
                                    y)
                        and torch.equal(hf.reshape(bt, hh, n, p), h)):
                    _fail(f"K4 {what}: differs from the flattened entry")
                what += ", bit-equal to the flattened entry"
            want_y, want_h = ssd_scan_grouped_ref(*ins)
            max_err = max(max_err, _check_k4(torch, what, y, h, want_y,
                                             want_h, dtype))
    k4.ssd_scan.launches = launches
    return max_err


def _launches_per_forward(cfg):
    """(K2 launches of one forward, K3 and K4 launches of one prefill)."""
    attn_k2 = len(cfg.lora.targets)
    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        return attn_k2 * cfg.num_layers, cfg.num_layers, 0
    if cfg.arch_type == "ssm":
        return 2 * cfg.num_layers, 0, cfg.num_layers
    shared = cfg.num_layers // cfg.hybrid_period
    return 2 * cfg.num_layers + attn_k2 * shared, shared, cfg.num_layers


def _phase_serve_ref(torch, np, dev, kernels, tag="serve-ref",
                     arch=SERVE_REF_ARCH, seed=SERVE_REF_SEED,
                     tokens=SERVE_REF_TOKENS, prompt_len=16,
                     max_len=SERVE_REF_MAX_LEN):
    """The port's serving engine on the card against the JAX package's
    tokens on the same numpy weights (a smoke config, f32)."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import Request, ServingEngine

    k2, k3, k4 = kernels
    cfg = get_smoke_config(arch)
    params = convert.model_params(
        convert.random_model_params(cfg, seed), cfg, dev)
    prompts = serve_ref_prompts(np, cfg.vocab_size, seed, prompt_len)
    eng = ServingEngine(cfg, params, max_len=max_len, device=dev)
    _reset_counts(k2, k3, k4)
    out = eng.generate_batch([Request(p, SERVE_REF_NEW) for p in prompts])
    launches = (k2.lora_matmul.launches, k3.flash_attention.launches,
                k4.ssd_scan.launches)
    got = tuple(tuple(int(t) for t in o) for o in out)
    if got != tokens:
        _fail(f"[{tag}] tokens {got} != JAX {tokens}")
    per_fwd, n_k3, n_k4 = _launches_per_forward(cfg)
    want = (per_fwd * (1 + SERVE_REF_NEW), n_k3, n_k4)
    if launches != want:
        _fail(f"[{tag}] K2/K3/K4 launches {launches}, expected {want}")
    print(f"[{tag}] {cfg.name}: {len(got)} requests of {prompt_len} tokens x "
          f"{SERVE_REF_NEW} greedy tokens equal the JAX ServingEngine's; K2 "
          f"launched "
          f"{launches[0]} times, K3 {launches[1]}, K4 {launches[2]}")


# [dryrun]: one full-size combination on the production mesh, a subprocess
# under DRYRUN_TIMEOUT seconds
DRYRUN_ARGS = ["--arch", "olmo-1b", "--shape", "train_4k", "--mesh",
               "single"]
DRYRUN_TIMEOUT = 300
# the JAX package's per-device counts of that combination, its program as
# XLA's SPMD partitioner lays it out (PYTHONPATH=src python
# tools/jax_dryrun_refs.py); [dryrun] holds the port's record to them
JAX_DRYRUN = {
    'combination': ('olmo-1b', 'train_4k', '16x16'),
    'flops_per_device': 35128537513984.0,
    'collective_bytes': 79270641552.0,
    'collective_bytes_bf16eq': 39639777224.0,
    'bytes_per_device': 2156916776481.0,
    'bytes_per_device_bf16eq': 1118116641583.0,
}
# dot FLOPs within this share of the reference's (after layer0_grads);
# bf16-equivalent collective bytes at most this many times the reference's
DRYRUN_FLOPS_REL = 0.02
DRYRUN_COLLECTIVE_BOUND = 1.25


def layer0_grads(cfg, seq: int, seqs: int, model: int) -> float:
    """Per device, the products of an attention stack's layer 0 that only
    the reference's training backward runs (it differentiates a scan whose
    body is every layer's; layer 0's input, the frozen embedding, needs no
    gradient): the input gradient through the q, k and v projections and
    the adapters' A, and the gradient of K. On ``seqs`` sequences of
    ``seq`` tokens and this rank's block of heads (``model`` ranks split
    the heads where they divide them); the width stays whole."""
    def split(n):
        return n // model if n % model == 0 else n

    t, d, r = seqs * seq, cfg.d_model, cfg.lora.rank
    heads = split(cfg.num_heads)
    outs = (heads + 2 * split(cfg.num_kv_heads)) * cfg.head_dim
    adapted = sum(x in cfg.lora.targets for x in ("q", "k", "v"))
    d_k = 2.0 * seqs * heads * seq * seq * cfg.head_dim
    return 2.0 * t * d * outs + 2.0 * t * r * d * adapted + d_k

# [serve]'s kernel-run timings and peak memory, by phase tag, for [roofline]
STEP_RUNS = {}


def _teacher_forced(torch, tf, cfg, params, prompts, tokens, max_len,
                    kcfg):
    """Prefill on the prompts, then one decode step per given token.
    Returns (last-position logits of every forward (F, B, V) f32, prefill
    seconds, decode seconds per step)."""
    dev = params["embed"].device
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tf.prefill(cfg, params,
                                   {"tokens": prompts.to(dev)},
                                   max_len, kcfg)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        outs = [logits[:, -1]]
        t0 = time.perf_counter()
        for i in range(tokens.shape[1]):
            logits, cache = tf.decode_step(
                cfg, params, {"tokens": tokens[:, i:i + 1]}, cache, kcfg)
            outs.append(logits[:, -1])
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / tokens.shape[1]
    return torch.stack(outs), t_pre, t_dec


def _lora_pairs(tree):
    """Every LoRA {a, b} pair of a port parameter tree."""
    if isinstance(tree, list):
        for v in tree:
            yield from _lora_pairs(v)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k == "lora":
                yield from v.values()
            else:
                yield from _lora_pairs(v)


def _phase_serve(torch, np, dev, kernels, tag="serve", arch=SERVE_ARCH,
                 batch=SERVE_BATCH, prompt=SERVE_PROMPT, new=SERVE_NEW,
                 max_len=SERVE_MAX_LEN, layers=None, f32_layers=None):
    """A config at full width (and full depth, unless ``layers`` cuts it),
    bf16, on the card: ``batch`` prompts of ``prompt`` tokens, ``new``
    greedy new tokens each, through ServingEngine. The logits are held to
    the plain run at the served depth, or at ``f32_layers`` layers where
    the f32 copy does not fit beside the bf16 weights (MoE always: see
    ROUTE_SWAP_MARGIN). Returns the launches of K2 at prefill, of K2 at
    decode, of K3 and of K4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServingEngine

    k2, k3, k4 = kernels
    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params, _, init_s = _draw_model(torch, tf, cfg, dev)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    eng = ServingEngine(cfg, params, max_len=max_len, device=dev)
    # warm-up (first-call costs stay out of the timings)
    eng.generate_batch([Request(p[:16], 2) for p in prompts])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # K2's launches before the first decode step are the prefill's
    at_decode = []
    decode_step = tf.decode_step

    def note_decode(*args, **kwargs):
        if not at_decode:
            at_decode.append(k2.lora_matmul.launches)
        return decode_step(*args, **kwargs)

    _reset_counts(k2, k3, k4)
    tf.decode_step = note_decode
    try:
        t0 = time.perf_counter()
        out = eng.generate_batch([Request(p, new) for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tf.decode_step = decode_step
    launches = (at_decode[0], k2.lora_matmul.launches - at_decode[0],
                k3.flash_attention.launches, k4.ssd_scan.launches)
    peak = torch.cuda.max_memory_allocated()
    per_forward, n_k3, n_k4 = _launches_per_forward(cfg)
    want = (per_forward, per_forward * new, n_k3, n_k4)
    if launches != want:
        _fail(f"[{tag}] K2 prefill / K2 decode / K3 / K4 launches "
              f"{launches}, expected {want}")
    tokens = np.stack(out)
    if tokens.shape != (batch, new) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        _fail(f"[{tag}] tokens of shape {tokens.shape} out of range")
    depth = (f"{cfg.num_layers} of its {full_layers} layers: depth cut, "
             "width as published" if cfg.num_layers < full_layers
             else f"{cfg.num_layers} layers")
    print(f"[{tag}] {cfg.name} ({depth}, d {cfg.d_model}, "
          f"{(cfg.param_count() + cfg.lora_param_count()) / 1e9:.3f} G "
          f"parameters, bf16) drawn on the card in "
          f"{init_s:.2f} s; {batch} x {prompt}-token prompts, "
          f"{new} greedy tokens each: {wall:.3f} s, "
          f"{batch * new / wall:.1f} tokens/s; K2 launched "
          f"{launches[0] + launches[1]} times ({launches[0]} at prefill), "
          f"K3 {launches[2]}, K4 {launches[3]}; peak memory "
          f"{peak / 2**30:.2f} GiB")

    prompts_t = torch.from_numpy(prompts.astype(np.int64))
    tokens_t = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    with _Routes(torch, moe_lib) as kern_routes:
        kern, pre_s, dec_s = _teacher_forced(torch, tf, cfg, params,
                                             prompts_t, tokens_t, max_len,
                                             KernelConfig(True))
    with _Routes(torch, moe_lib) as plain_routes:
        plain, pre_p, dec_p = _teacher_forced(torch, tf, cfg, params,
                                              prompts_t, tokens_t, max_len,
                                              KernelConfig(False))
    if not bool(torch.isfinite(kern).all()):
        _fail(f"[{tag}] non-finite logits in the kernel run")
    STEP_RUNS[tag] = {"prefill_s": pre_s, "decode_s": dec_s, "peak": peak}
    print(f"[{tag}] teacher-forced on the engine's tokens: kernel run "
          f"prefill {pre_s:.3f} s, decode {dec_s * 1e3:.2f} ms/step; plain "
          f"run prefill {pre_p:.3f} s, decode {dec_p * 1e3:.2f} ms/step")
    if tag != "serve-hybrid":
        _phase_trace(torch, tf, cfg, params, prompts_t, tokens_t, max_len,
                     cfg.name)
    del eng
    if cfg.arch_type == "moe":
        _moe_checks(torch, tf, cfg, params, prompts_t, tokens_t, max_len,
                    tag, (kern, kern_routes.calls),
                    (plain, plain_routes.calls), f32_layers)
        return launches
    if f32_layers is not None:
        diff = (kern - plain).abs()
        print(f"[{tag}] bf16, {cfg.num_layers} layers: last-position "
              f"logits of {kern.shape[0]} forwards, max |kernel - plain| "
              f"{float(diff.max()):.4f}, mean {float(diff.mean()):.2e}, max "
              f"|logit| {float(kern.abs().max()):.3f}; greedy tokens agree "
              f"on {float((kern.argmax(-1) == plain.argmax(-1)).float().mean()):.1%}"
              f" (reported: the f32 copy does not fit beside the bf16 "
              f"weights; the rule is held at {f32_layers} layers)")

        def run(c, p, use_cuda):
            return _teacher_forced(torch, tf, c, p, prompts_t, tokens_t,
                                   max_len, KernelConfig(use_cuda))[0]

        _cut_checks(torch, tag, cfg, params, run, f32_layers)
        return launches
    if tag == "serve":
        bound = SERVE_LOGIT_ATOL
    else:
        k32, p32 = _f32_logits(torch, tf, cfg, params, prompts_t, tokens_t,
                               max_len)
        d32 = float((k32 - p32).abs().max())
        floor = float((plain - p32).abs().max())
        kern_off = float((kern - p32).abs().max())
        print(f"[{tag}] the same weights widened to f32: max |kernel - "
              f"plain| {d32:.3e} (bound {F32_LOGIT_ATOL}); bf16 drift from "
              f"the f32 plain run: plain run {floor:.4f}, kernel run "
              f"{kern_off:.4f}")
        if not d32 <= F32_LOGIT_ATOL:
            _fail(f"[{tag}] f32 logits of the kernel and plain runs differ "
                  f"by {d32} > {F32_LOGIT_ATOL}")
        bound = 2.0 * floor
    diff = (kern - plain).abs()
    max_d = float(diff.max())
    if max_d > bound:
        _fail(f"[{tag}] logits of the kernel and plain runs differ by "
              f"{max_d} > {bound}")
    same_engine = float((kern[:-1].argmax(-1).T == tokens_t).float().mean())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"[{tag}] last-position logits of {kern.shape[0]} forwards: max "
          f"|kernel - plain| {max_d:.4f} (bound {bound:.4f}), mean "
          f"{float(diff.mean()):.2e}, max |logit| {float(kern.abs().max()):.3f}"
          f"; greedy tokens agree on {agree:.1%}; the engine's tokens equal "
          f"the kernel run's argmax on {same_engine:.1%}")
    return launches


class _Routes:
    """Records a run's MoE routing: every ``moe.route`` call's top-k expert
    set (sorted) and router logits (``calls``) and its experts in the
    route's order (``idx``), in call order (layer by layer, prefill then
    each decode step; a remat training step's recompute after its
    forward). Records nothing for a model without MoE. With ``replay``
    (another run's ``idx``) the i-th call routes by the replayed experts
    instead (``_replayed``), and still records its own routing."""

    def __init__(self, torch, moe_lib, replay=None):
        self.torch, self.mod, self.replay = torch, moe_lib, replay
        self.calls, self.idx = [], []

    def __enter__(self):
        self.route = self.mod.route

        def record(cfg, router_w, x):
            out = self.route(cfg, router_w, x)
            logits = (x.float() @ router_w.float()).detach()
            self.calls.append((self.torch.sort(out[0], dim=-1).values,
                               logits))
            self.idx.append(out[0])
            if self.replay is not None:
                out = _replayed(self.torch, cfg, router_w, x,
                                self.replay[len(self.idx) - 1])
            return out

        self.mod.route = record
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route


def _replayed(torch, cfg, router_w, x, idx):
    """``moe.route``'s result with the experts ``idx`` given: the router
    weights and the load-balance loss from this call's own gates, as
    ``moe.route`` takes them from its top k."""
    import torch.nn.functional as F

    m = cfg.moe
    gates = torch.softmax(x.float() @ router_w.float(), dim=-1)
    w = torch.gather(gates, -1, idx)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    ce = F.one_hot(idx[..., 0], m.num_experts).float().mean(dim=-2)
    aux = (m.num_experts * torch.sum(gates.mean(dim=-2) * ce, dim=-1)
           * m.aux_loss_coef)
    return idx, w.to(x.dtype), aux


def _route_swaps(torch, cfg, a_calls, b_calls, prompt):
    """Compare two runs' routing (``_Routes.calls``, the same forwards in
    the same order; run b is the baseline). Returns a dict: ``swaps`` and
    ``first`` (a token's swap at its lowest layer) a layer, ``first_gap``
    (b's largest 2nd - 3rd router-logit gap at a first swap, a layer),
    ``diff`` (the largest router-logit difference at tokens with no swap at
    this layer or below, a layer) and ``swapped`` (layers, B, positions)
    bool. Fails if a swap
    does not follow from the logits: b's 2nd - 3rd gap over twice the two
    runs' largest logit difference at that token."""
    n_layers = cfg.num_layers
    if len(a_calls) != len(b_calls) or len(a_calls) % n_layers:
        _fail(f"routing calls {len(a_calls)} / {len(b_calls)} for "
              f"{n_layers} layers")
    n_fwd = len(a_calls) // n_layers
    b = a_calls[0][0].shape[0]
    dev = a_calls[0][0].device
    n_pos = prompt + n_fwd - 1
    swapped = torch.zeros((n_layers, b, n_pos), dtype=torch.bool, device=dev)
    gap = torch.zeros((n_layers, b, n_pos), device=dev)
    diff = [0.0] * n_layers
    for c, ((ia, la), (ib, lb)) in enumerate(zip(a_calls, b_calls)):
        f, layer = divmod(c, n_layers)
        at = slice(0, prompt) if f == 0 else slice(prompt + f - 1,
                                                   prompt + f)
        sw = (ia != ib).any(-1)
        top3 = lb.topk(3, dim=-1).values
        g = top3[..., 1] - top3[..., 2]
        d = (la - lb).abs().amax(-1)
        if bool((g[sw] > 2 * d[sw]).any()):
            _fail(f"a routing swap at layer {layer} of forward {f} that the "
                  "router logits do not explain")
        swapped[layer, :, at] = sw
        gap[layer, :, at] = g
        clean = ~swapped[:layer + 1, :, at].any(0)
        if bool(clean.any()):
            diff[layer] = max(diff[layer], float(d[clean].max()))
    before = torch.cumsum(swapped.int(), dim=0) - swapped.int()
    first = swapped & (before == 0)
    first_gap = [float(gap[i][first[i]].max()) if bool(first[i].any())
                 else 0.0 for i in range(n_layers)]
    return {"swaps": swapped.sum(dim=(1, 2)).tolist(),
            "first": first.sum(dim=(1, 2)).tolist(),
            "first_gap": first_gap, "diff": diff, "swapped": swapped}


def _agree(swaps, prompt):
    """(F, B) bool: forwards whose last token took the same experts in every
    layer in every compared pair of runs."""
    tok = None
    for sw in swaps:
        one = sw["swapped"].any(0)
        tok = one if tok is None else tok | one
    return ~tok[:, prompt - 1:].T


def _print_swaps(tag, what, sw):
    print(f"[{tag}] {what}: routing swaps a layer {sw['swaps']}, first "
          f"swaps {sw['first']}; the largest 2nd - 3rd router-logit gap at "
          f"a first swap, a layer: "
          f"{[round(g, 4) for g in sw['first_gap']]}; router logits at "
          "tokens not swapped up to the layer differ by at most, a layer: "
          f"{[float(f'{d:.3g}') for d in sw['diff']]}")


def _moe_checks(torch, tf, cfg, params, prompts_t, tokens_t, max_len, tag,
                kern_run, plain_run, layers):
    """[serve-moe]'s routing and logit checks (see ROUTE_SWAP_MARGIN): the
    bf16 runs at the served depth; then the first ``layers`` layers (the
    others freed), bf16 and widened to f32, each run with the kernels and
    plain."""
    import dataclasses

    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import moe as moe_lib

    prompt = prompts_t.shape[1]
    sw = _route_swaps(torch, cfg, kern_run[1], plain_run[1], prompt)
    _print_swaps(tag, f"bf16, {cfg.num_layers} layers", sw)
    if sw["first_gap"][0] > ROUTE_SWAP_MARGIN:
        _fail(f"[{tag}] a first-layer routing swap where the plain run's 2nd "
              f"and 3rd router logits were {sw['first_gap'][0]} apart "
              f"(> {ROUTE_SWAP_MARGIN})")
    agree = _agree([sw], prompt)
    diff = (kern_run[0] - plain_run[0]).abs().amax(-1)            # (F, B)
    print(f"[{tag}] bf16, {cfg.num_layers} layers: last-position logits, "
          f"kernel run against plain run: max "
          f"{float(diff.max()):.4f} over all {diff.numel()} (forward, row) "
          f"pairs, {float(diff[agree].max()) if bool(agree.any()) else 0:.4f}"
          f" over the {int(agree.sum())} whose last token's routing agrees "
          "(reported: the random init amplifies differences with depth)")

    del params["layers"][layers:]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cut = dataclasses.replace(cfg, num_layers=layers)
    cfg32 = dataclasses.replace(cut, dtype="float32")
    p32 = _widen(params)
    runs = {}
    for name, c, p, use_cuda in (("bf16 kernel", cut, params, True),
                                 ("bf16 plain", cut, params, False),
                                 ("f32 kernel", cfg32, p32, True),
                                 ("f32 plain", cfg32, p32, False)):
        with _Routes(torch, moe_lib) as routes:
            logits = _teacher_forced(torch, tf, c, p, prompts_t, tokens_t,
                                     max_len, KernelConfig(use_cuda))[0]
        if not bool(torch.isfinite(logits).all()):
            _fail(f"[{tag}] non-finite logits in the {name} run")
        runs[name] = (logits, routes.calls)
    pairs = {what: _route_swaps(torch, cut, runs[a][1], runs[b][1], prompt)
             for what, a, b in (("bf16", "bf16 kernel", "bf16 plain"),
                                ("f32", "f32 kernel", "f32 plain"),
                                ("bf16 plain / f32", "bf16 plain",
                                 "f32 plain"))}
    for what, pair in pairs.items():
        _print_swaps(tag, f"{layers} layers, {what} runs", pair)
    agree = _agree(pairs.values(), prompt)
    if not bool(agree.any()):
        _fail(f"[{tag}] no forward whose routing agrees in all four runs")

    def dist(a, b):
        return float((runs[a][0] - runs[b][0]).abs().amax(-1)[agree].max())

    d32 = dist("f32 kernel", "f32 plain")
    floor = dist("bf16 plain", "f32 plain")
    d16 = dist("bf16 kernel", "bf16 plain")
    print(f"[{tag}] {layers} layers, the {int(agree.sum())} of "
          f"{agree.numel()} (forward, row) pairs whose last token's routing "
          f"agrees in all four runs: f32 max |kernel - plain| {d32:.3e} "
          f"(bound {F32_LOGIT_ATOL}); bf16 max |kernel - plain| {d16:.4f} "
          f"(bound twice the bf16 plain run's drift from the f32 plain run, "
          f"{2 * floor:.4f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not d32 <= F32_LOGIT_ATOL:
        _fail(f"[{tag}] f32 logits of the kernel and plain runs differ by "
              f"{d32} > {F32_LOGIT_ATOL}")
    if not d16 <= 2 * floor:
        _fail(f"[{tag}] bf16 logits of the kernel and plain runs differ by "
              f"{d16} > {2 * floor}")


def _reset_counts(k2, k3, k4) -> None:
    """Every kernel count set to 0 before a main-path run."""
    k2.lora_matmul.launches = 0
    k2.lora_matmul.backward_launches = 0
    k3.flash_attention.launches = 0
    k3.flash_attention.position_launches = 0
    k3.flash_attention_backward.launches = 0
    k4.ssd_scan.launches = 0
    k4.ssd_scan.backward_launches = 0


def _train_counts(k2, k3, k4) -> tuple:
    """(K2 forward, K2 backward, K3, K4, K4 backward, K3 backward) launches
    since the last reset."""
    return (k2.lora_matmul.launches, k2.lora_matmul.backward_launches,
            k3.flash_attention.launches, k4.ssd_scan.launches,
            k4.ssd_scan.backward_launches,
            k3.flash_attention_backward.launches)


def _counts(k2, k3) -> tuple:
    """(K2, K3, K3 with positions) launches since the last reset."""
    return (k2.lora_matmul.launches, k3.flash_attention.launches,
            k3.flash_attention.position_launches)


def _phase_k3_positions(torch, np, gen, k3, flash_attention_ref) -> float:
    """K3's position inputs against its plain version with the same
    positions: Qwen2-VL's M-RoPE temporal stream with an image span at the
    start, in the middle and at the end; repeated, non-monotone positions;
    a window; no causal mask; queries before every key (rows that keep no
    key average V over all keys); each at f32 and bf16, D 64, 80 and 128,
    ragged S; Qwen2-VL's prefill shape. Then positions 0, 1, ... passed
    explicitly, bit-equal to the index path (null positions)."""
    from repro_torch.models.frontends import make_mrope_positions

    dev = gen.device

    def ivec(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def span(s, start, h, w):
        return ivec(make_mrope_positions(1, s, (start, h, w))[0, :, 0])

    s = 333
    cases = []
    for dt in ("float32", "bfloat16"):
        for d in (64, 80, 128):
            mid = span(s, 150, 4, 8)
            for where, p in (("start", span(s, 0, 4, 8)), ("middle", mid),
                             ("end", span(s, s - 32, 4, 8))):
                cases.append((f"span at the {where}", 3, s, d, dt, True,
                              None, p, p))
            mixed = ivec(np.random.default_rng(d).integers(0, s // 2, s))
            ar = ivec(np.arange(s))
            cases += [("repeated, non-monotone", 3, s, d, dt, True, None,
                       mixed, mixed),
                      ("span in the middle, window 37", 3, s, d, dt, True,
                       37, mid, mid),
                      ("span in the middle, not causal", 3, s, d, dt, False,
                       None, mid, mid),
                      ("queries 8 before their keys", 3, s, d, dt, True,
                       None, ar - 8, ar)]
    arch, batch, prompt, (start, h, w), _, _ = VLM_RUN
    vlm_pos = span(prompt, start, h, w)
    cases.append((f"{arch}'s prefill, span {(start, h, w)}", batch * 28,
                  prompt, 128, "bfloat16", True, None, vlm_pos, vlm_pos))
    max_err = 0.0
    counts = (k3.flash_attention.launches,
              k3.flash_attention.position_launches)
    for what, bh, sq, d, dt, causal, window, q_pos, k_pos in cases:
        dtype = getattr(torch, dt)
        q, k, v = (_randn(torch, gen, (bh, sq, d), 1.0, dtype)
                   for _ in range(3))
        o = k3.flash_attention(q, k, v, causal=causal, window=window,
                               q_pos=q_pos, k_pos=k_pos)
        torch.cuda.synchronize()
        want = flash_attention_ref(q[None], k[None], v[None], causal=causal,
                                   window=window, q_pos=q_pos,
                                   k_pos=k_pos)[0]
        label = (f"positions: {what}, {dt} (BH, S, D) = {(bh, sq, d)} "
                 f"causal={causal} window={window}")
        err = _close(torch, f"K3 {label}", o, want, *K3_TOL[dt])
        max_err = max(max_err, err)
        print(f"[k3] {label}: max |err| {err:.3e} within rtol/atol "
              f"{K3_TOL[dt]}")
    n_equal = 0
    shapes = [(2, sq, sk, d, dt, causal, window)
              for dt in ("float32", "bfloat16") for d in (64, 80, 128)
              for sq, sk in ((1, 1), (65, 65), (200, 200), (129, 300))
              for causal, window in ((True, None), (True, 37), (False, None),
                                     (False, 50))]
    shapes.append((batch * 28, prompt, prompt, 128, "bfloat16", True, None))
    for bh, sq, sk, d, dt, causal, window in shapes:
        dtype = getattr(torch, dt)
        q = _randn(torch, gen, (bh, sq, d), 1.0, dtype)
        k, v = (_randn(torch, gen, (bh, sk, d), 1.0, dtype)
                for _ in range(2))
        base = k3.flash_attention(q, k, v, causal=causal, window=window)
        got = k3.flash_attention(q, k, v, causal=causal, window=window,
                                 q_pos=ivec(np.arange(sq)),
                                 k_pos=ivec(np.arange(sk)))
        if not torch.equal(got, base):
            _fail(f"[k3] explicit positions 0, 1, ... differ from the index "
                  f"path at {dt} (BH, Sq, Sk, D) = {(bh, sq, sk, d)} "
                  f"causal={causal} window={window}")
        n_equal += 1
    k3.flash_attention.launches, k3.flash_attention.position_launches = \
        counts
    print(f"[k3] positions 0, 1, ... passed explicitly: bit-equal to the "
          f"index path in all {n_equal} cases (f32 and bf16, D 64 / 80 / "
          "128, Sq = Sk and Sq < Sk, causal, window, neither; Qwen2-VL's "
          "prefill shape)")
    return max_err


def _embed_run(torch, tf, cfg, params, table, embeds, positions, max_len,
               kcfg, new, tokens=None):
    """A model fed embeddings: prefill on ``embeds`` (B, S, d) with
    ``positions``, then ``new`` decode steps, each fed the text-table row of
    a token: the previous forward's argmax (greedy) or ``tokens[:, i]``
    (teacher-forced). Returns (last-position logits of every forward
    (new + 1, B, V) f32, the tokens fed (B, new), prefill s, decode s a
    step)."""
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tf.prefill(cfg, params, {"embeds": embeds,
                                                 "positions": positions},
                                   max_len, kcfg)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        outs, fed = [logits[:, -1]], []
        t0 = time.perf_counter()
        for i in range(new):
            tok = outs[-1].argmax(-1) if tokens is None else tokens[:, i]
            fed.append(tok)
            logits, cache = tf.decode_step(
                cfg, params, {"embeds": table[tok][:, None]}, cache, kcfg)
            outs.append(logits[:, -1])
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / max(new, 1)
    return (torch.stack(outs), torch.stack(fed, 1) if fed else None, t_pre,
            t_dec)


def _phase_vlm_ref(torch, np, dev, kernels):
    """[vlm-ref]: the qwen2-vl-7b smoke config on the card against the JAX
    package's greedy tokens (VLM_REF)."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.frontends import make_mrope_positions

    k2, k3, k4 = kernels
    arch, seed, batch, seq, span, new, max_len = VLM_REF
    cfg = get_smoke_config(arch)
    params = convert.model_params(convert.random_model_params(cfg, seed),
                                  cfg, dev)
    embeds, table = (torch.from_numpy(a).to(dev) for a in frontend_ref_inputs(
        np, cfg.d_model, cfg.vocab_size, seed, batch, seq))
    pos = torch.from_numpy(make_mrope_positions(batch, seq, span)).to(dev)
    _reset_counts(k2, k3, k4)
    logits = _embed_run(torch, tf, cfg, params, table, embeds, pos, max_len,
                        KernelConfig(True), new)[0]
    launches = _counts(k2, k3)
    got = tuple(tuple(int(t) for t in row)
                for row in logits.argmax(-1).T.cpu().tolist())
    if got != VLM_REF_TOKENS:
        _fail(f"[vlm-ref] tokens {got} != JAX {VLM_REF_TOKENS}")
    n = cfg.num_layers
    want = (len(cfg.lora.targets) * n * (1 + new), n, n)
    if launches != want:
        _fail(f"[vlm-ref] K2 / K3 / K3-with-positions launches {launches}, "
              f"expected {want}")
    print(f"[vlm-ref] {cfg.name}: {batch} prompts of {seq} embeddings, image "
          f"span {span}, prefill + {new} greedy steps: the {new + 1} argmax "
          f"tokens of each row equal JAX's; K2 launched {launches[0]} times, "
          f"K3 {launches[1]} ({launches[2]} with positions)")


def _phase_audio_ref(torch, np, dev, kernels):
    """[audio-ref]: the hubert-xlarge smoke config's forward on the card
    against the JAX package's ids and logits (AUDIO_REF)."""
    import zlib

    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import transformer as tf

    k2, k3, k4 = kernels
    arch, seed, batch, seq = AUDIO_REF
    cfg = get_smoke_config(arch)
    params = convert.model_params(convert.random_model_params(cfg, seed),
                                  cfg, dev)
    embeds, _ = frontend_ref_inputs(np, cfg.d_model, cfg.vocab_size, seed,
                                    batch, seq)
    _reset_counts(k2, k3, k4)
    with torch.no_grad():
        logits, _ = tf.forward(cfg, params,
                               {"embeds": torch.from_numpy(embeds).to(dev)},
                               KernelConfig(True))
    launches = _counts(k2, k3)
    ids = logits.argmax(-1).to(torch.int32).cpu().numpy()
    crc = zlib.crc32(ids.tobytes())
    if crc != AUDIO_REF_IDS_CRC:
        _fail(f"[audio-ref] CRC32 of the argmax ids {crc} != JAX "
              f"{AUDIO_REF_IDS_CRC}")
    sample = logits[AUDIO_REF_SAMPLE].reshape(-1)
    err = _close(torch, "[audio-ref] logits", sample,
                 torch.tensor(AUDIO_REF_LOGITS, device=dev), 0.0,
                 AUDIO_REF_ATOL)
    n = cfg.num_layers
    if launches != (len(cfg.lora.targets) * n, n, 0):
        _fail(f"[audio-ref] K2 / K3 / K3-with-positions launches {launches}")
    print(f"[audio-ref] {cfg.name}: {batch} x {seq} frames, one forward: the "
          f"per-frame argmax codebook ids equal JAX's (CRC32 {crc}); "
          f"{sample.numel()} sampled logits within {AUDIO_REF_ATOL} (max "
          f"|err| {err:.3e}); K2 launched {launches[0]} times, K3 "
          f"{launches[1]} (non-causal, no positions)")


def _draw_model(torch, tf, cfg, dev):
    """(a config's weights drawn on the card from SEED, LoRA B ~ N(0,
    SERVE_LORA_B_STD), and for DENSE_RUNS' archs every bias ~ N(0, 0.1) and
    norm scale ~ 1 + N(0, 0.1) and norm bias ~ N(0, 0.1), as
    ``convert.random_model_params`` draws them (the init's zeros and ones
    would leave those features idle); the generator, to draw on; the
    seconds it took)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg)
    for pair in _lora_pairs(params):
        pair["b"].normal_(0.0, SERVE_LORA_B_STD, generator=gen)
    if cfg.name in {run[0] for run in DENSE_RUNS.values()}:
        for x, mean in _affine_leaves(params):
            x.normal_(mean, 0.1, generator=gen)
    torch.cuda.synchronize()
    return params, gen, time.perf_counter() - t0


def _affine_leaves(tree):
    """(tensor, its init's value) of every bias and norm parameter of a
    port parameter tree: attention's q / k / v / o biases (0) and each
    norm's scale (1) and bias (0)."""
    if isinstance(tree, list):
        for v in tree:
            yield from _affine_leaves(v)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("bq", "bk", "bv", "bo"):
                yield v, 0.0
            elif k.endswith("norm"):
                for name, x in v.items():
                    yield x, 1.0 if name == "scale" else 0.0
            elif k != "lora":
                yield from _affine_leaves(v)


def _trace_call(torch, what, fn, exclusive=None):
    """torch.profiler over one call of ``fn`` (the profiler's own host cost
    is in the wall time), read by ``_trace_line``; grad mode is off unless
    ``exclusive`` ranges are asked for (a train step). Returns
    ``_trace_line``'s parts."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if exclusive else torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return _trace_line(torch, what, prof, wall, exclusive)


def _family_checks(torch, tag, cfg, params, run, kern):
    """[vlm]'s and [audio]'s logit rule (FAMILY_RUNS'): ``run(cfg, params,
    use_cuda)`` gives a run's logits, ``kern`` the kernel run's at full
    depth. bf16 kernel run against bf16 plain run within twice the bf16
    plain run's distance from the f32 plain run, at full depth; then at
    FAMILY_F32_LAYERS layers (the others freed) the same, and the f32
    kernel run against the f32 plain run within F32_LOGIT_ATOL."""
    import dataclasses

    def dist(a, b):
        return float((a - b).abs().max())

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    plain = run(cfg, params, False)
    p32 = _widen(params)
    plain32 = run(cfg32, p32, False)
    del p32
    torch.cuda.empty_cache()
    d16, floor = dist(kern, plain), dist(plain, plain32)
    print(f"[{tag}] bf16, {cfg.num_layers} layers: max |kernel - plain| "
          f"{d16:.4f} (bound twice the bf16 plain run's drift from the f32 "
          f"plain run, {2 * floor:.4f}); kernel run's drift "
          f"{dist(kern, plain32):.4f}; max |logit| "
          f"{float(kern.abs().max()):.3f}; argmax agrees on "
          f"{float((kern.argmax(-1) == plain.argmax(-1)).float().mean()):.1%}")
    if not d16 <= 2 * floor:
        _fail(f"[{tag}] bf16 logits of the kernel and plain runs differ by "
              f"{d16} > {2 * floor}")
    _cut_checks(torch, tag, cfg, params, run, FAMILY_F32_LAYERS)


def _cut_checks(torch, tag, cfg, params, run, layers):
    """FAMILY_RUNS' logit rule at ``layers`` layers (the others freed):
    ``run(cfg, params, use_cuda)`` gives a run's logits. The weights widened
    to f32 hold the kernel run within F32_LOGIT_ATOL of the plain run; in
    bf16 the kernel run lies within twice the bf16 plain run's distance
    from the f32 plain run."""
    import dataclasses

    def dist(a, b):
        return float((a - b).abs().max())

    del params["layers"][layers:]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cut = dataclasses.replace(cfg, num_layers=layers)
    cut32 = dataclasses.replace(cut, dtype="float32")
    k16, p16 = run(cut, params, True), run(cut, params, False)
    p32 = _widen(params)
    k32, pl32 = run(cut32, p32, True), run(cut32, p32, False)
    d32, d16, floor = dist(k32, pl32), dist(k16, p16), dist(p16, pl32)
    print(f"[{tag}] {layers} layers: f32 max |kernel - plain| "
          f"{d32:.3e} (bound {F32_LOGIT_ATOL}); bf16 max |kernel - plain| "
          f"{d16:.4f} (bound {2 * floor:.4f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not d32 <= F32_LOGIT_ATOL:
        _fail(f"[{tag}] f32 logits of the kernel and plain runs differ by "
              f"{d32} > {F32_LOGIT_ATOL}")
    if not d16 <= 2 * floor:
        _fail(f"[{tag}] bf16 logits at {layers} layers differ by "
              f"{d16} > {2 * floor}")


def _phase_vlm(torch, np, dev, kernels):
    """[vlm]: qwen2-vl-7b at full width and depth, bf16 (VLM_RUN), prefill
    and greedy decode on embeddings with an image span; launch counts,
    times, a traced prefill and the logit rule. Returns (K2 at prefill, K2
    at decode, K3, K3 with positions) launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.frontends import (make_frontend_embeddings,
                                              make_mrope_positions)

    k2, k3, k4 = kernels
    arch, batch, prompt, span, new, max_len = VLM_RUN
    cfg = get_config(arch)
    params, gen, init_s = _draw_model(torch, tf, cfg, dev)
    table = _randn(torch, gen, (cfg.vocab_size, cfg.d_model), 0.02,
                   torch.bfloat16)
    embeds = make_frontend_embeddings(gen, cfg, batch, prompt)
    pos = torch.from_numpy(make_mrope_positions(batch, prompt, span)).to(dev)
    # warm-up (first-call costs stay out of the timings)
    _embed_run(torch, tf, cfg, params, table, embeds[:, :16], pos[:, :16],
               max_len, KernelConfig(True), 2)
    torch.cuda.reset_peak_memory_stats()

    at_decode = []
    decode_step = tf.decode_step

    def note_decode(*args, **kwargs):
        if not at_decode:
            at_decode.append(k2.lora_matmul.launches)
        return decode_step(*args, **kwargs)

    _reset_counts(k2, k3, k4)
    tf.decode_step = note_decode
    try:
        t0 = time.perf_counter()
        kern, tokens, pre_s, dec_s = _embed_run(
            torch, tf, cfg, params, table, embeds, pos, max_len,
            KernelConfig(True), new)
        wall = time.perf_counter() - t0
    finally:
        tf.decode_step = decode_step
    total = _counts(k2, k3)
    launches = (at_decode[0], total[0] - at_decode[0], total[1], total[2])
    n = cfg.num_layers
    per_fwd = len(cfg.lora.targets) * n
    want = (per_fwd, per_fwd * new, n, n)
    if launches != want:
        _fail(f"[vlm] K2 prefill / K2 decode / K3 / K3 with positions "
              f"launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(kern).all()):
        _fail("[vlm] non-finite logits in the kernel run")
    print(f"[vlm] {cfg.name} ({n} layers, d {cfg.d_model}, "
          f"{(cfg.param_count() + cfg.lora_param_count()) / 1e9:.3f} G "
          f"parameters and a {cfg.vocab_size} x {cfg.d_model} text table, "
          f"bf16) drawn on the card in {init_s:.2f} s; {batch} x "
          f"{prompt}-embedding prompts, image span {span}, {new} greedy "
          f"tokens each: {wall:.3f} s ({batch * new / wall:.1f} tokens/s), "
          f"prefill {pre_s:.3f} s, decode {dec_s * 1e3:.2f} ms/step; K2 "
          f"launched {launches[0] + launches[1]} times ({launches[0]} at "
          f"prefill), K3 {launches[2]} ({launches[3]} with positions); peak "
          f"memory {peak / 2**30:.2f} GiB")
    _trace_call(torch, f"{cfg.name} prefill", lambda: tf.prefill(
        cfg, params, {"embeds": embeds, "positions": pos}, max_len,
        KernelConfig(True)))

    def run(c, p, use_cuda):
        out = _embed_run(torch, tf, c, p, table, embeds, pos, max_len,
                         KernelConfig(use_cuda), new, tokens)
        if c is cfg and not use_cuda:
            print(f"[vlm] plain run, teacher-forced on the kernel run's "
                  f"tokens: prefill {out[2]:.3f} s, decode "
                  f"{out[3] * 1e3:.2f} ms/step")
        return out[0]

    _family_checks(torch, "vlm", cfg, params, run, kern)
    return launches


def _phase_audio(torch, np, dev, kernels):
    """[audio]: hubert-xlarge at full width and depth, bf16 (AUDIO_RUN), one
    forward of frame embeddings; launch counts, frames/s, a traced forward
    and the logit rule. Returns (K2, K3) launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.frontends import make_frontend_embeddings

    k2, k3, k4 = kernels
    arch, batch, frames = AUDIO_RUN
    cfg = get_config(arch)
    params, gen, init_s = _draw_model(torch, tf, cfg, dev)
    embeds = make_frontend_embeddings(gen, cfg, batch, frames)

    def run(c, p, use_cuda):
        with torch.no_grad():
            return tf.forward(c, p, {"embeds": embeds},
                              KernelConfig(use_cuda))[0]

    run(cfg, params, True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(k2, k3, k4)
    t0 = time.perf_counter()
    kern = run(cfg, params, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(k2, k3)
    n = cfg.num_layers
    if launches != (len(cfg.lora.targets) * n, n, 0):
        _fail(f"[audio] K2 / K3 / K3 with positions launches {launches}, "
              f"expected {(len(cfg.lora.targets) * n, n, 0)}")
    if kern.shape != (batch, frames, cfg.vocab_size) or not bool(
            torch.isfinite(kern).all()):
        _fail(f"[audio] logits of shape {tuple(kern.shape)} or non-finite")
    peak = torch.cuda.max_memory_allocated()
    print(f"[audio] {cfg.name} ({n} layers, d {cfg.d_model}, "
          f"{(cfg.param_count() + cfg.lora_param_count()) / 1e9:.3f} G "
          f"parameters, bf16) drawn on the card in {init_s:.2f} s; one "
          f"forward of {batch} x {frames} frames: {wall:.3f} s, "
          f"{batch * frames / wall:.0f} frames/s; K2 launched {launches[0]} "
          f"times, K3 {launches[1]} (non-causal, D {cfg.head_dim}, BH "
          f"{batch * cfg.num_heads}); peak memory {peak / 2**30:.2f} GiB")
    _trace_call(torch, f"{cfg.name} forward",
                lambda: run(cfg, params, True))
    _family_checks(torch, "audio", cfg, params, run, kern)
    return launches[:2]


def _widen(tree):
    """A parameter tree with every tensor widened to f32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widen(v) for v in tree]
    return tree.float()


def _f32_logits(torch, tf, cfg, params, prompts_t, tokens_t, max_len):
    """The model with its weights widened to f32, teacher-forced on the same
    tokens: (kernel run's logits, plain run's logits)."""
    import dataclasses

    from repro_torch.kernels.ops import KernelConfig

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _widen(params)
    return tuple(_teacher_forced(torch, tf, cfg32, p32, prompts_t, tokens_t,
                                 max_len, KernelConfig(use_cuda))[0]
                 for use_cuda in (True, False))


# the port's kernels by the names of their CUDA functions
KERNEL_NAMES = {"K2": "lora_", "K3": "flash_fwd_", "K4": "ssd_scan_"}
# the library's matrix products and PyTorch's elementwise kernels, by the
# lower-cased parts of their names
LIBRARY_NAMES = {"cuBLAS": ("gemm", "cublas", "cutlass", "xmma", "nvjet"),
                 "elementwise": ("elementwise",)}


def _trace_line(torch, what, prof, wall_s, exclusive=None):
    """Device busy time of a traced window (the sum of the device-side
    events' durations: one stream, so they do not overlap; the host-side
    ops that launched them and the ranges' device-side annotations are left
    out, or a kernel would count twice) beside its wall time, the kernels
    that took most of it, their shares by KERNEL_NAMES and LIBRARY_NAMES,
    and the device time under each named range that ran: ops.ssd's (empty
    since K4 reads the model's layout), ops.attention's K / V repeat to
    every query head (GQA), and the MoE layer's route, dispatch, expert
    products and combine.

    ``exclusive`` ({range name: part}) also splits busy time into exclusive
    parts: a kernel inside the device span of one of those ranges counts
    for its part, any other by its name (K2, K3, cuBLAS, elementwise, the
    rest). Returns those parts in ms with ``wall_ms``, ``busy_ms`` and
    ``kernels_in`` (each exclusive part's count of device kernels) (None
    without ``exclusive`` or device events)."""
    import bisect

    from torch.autograd import DeviceType

    from repro_torch.kernels.ops import KV_REPEAT, SSD_COPIES
    from repro_torch.models import moe as moe_lib

    exclusive = exclusive or {}
    ranges = {SSD_COPIES, KV_REPEAT, moe_lib.ROUTE, moe_lib.DISPATCH,
              moe_lib.EXPERTS, moe_lib.COMBINE, *exclusive}
    kernels, spans, host = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() != DeviceType.CUDA:
            if name in ranges:
                host[name] = host.get(name, 0) + 1
        elif e.is_user_annotation():
            if name in ranges:
                spans.append((start, start + e.duration_ns(), name))
        elif e.duration_ns() > 0:
            kernels.append((start, start + e.duration_ns(), name))
    busy_us = sum(b - a for a, b, _ in kernels) / 1e3
    if busy_us == 0:
        print(f"[trace] {what}: wall {wall_s * 1e3:.1f} ms; device time not "
              "measured (the profiler recorded no device events)")
        return None
    by_name = {}
    for a, b, name in kernels:
        count, us = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, us + (b - a) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"[trace] {what}: wall {wall_s * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / (wall_s * 1e3):.1%}); "
          "top: " + "; ".join(f"{name[:60]} {us / 1e3:.1f} ms "
                              f"({us / busy_us:.1%}, {count}x)"
                              for name, (count, us) in top))
    parts_of = {**{k: (part,) for k, part in KERNEL_NAMES.items()},
                **LIBRARY_NAMES}

    def part_of(name):
        return next((k for k, ws in parts_of.items()
                     if any(w.lower() in name.lower() for w in ws)), "other")

    shares = dict.fromkeys(parts_of, 0.0)
    for name, (_, us) in by_name.items():
        if part_of(name) in shares:
            shares[part_of(name)] += us
    print(f"[trace] {what}: " + "; ".join(
        f"{name} {us / 1e3:.1f} ms ({us / busy_us:.1%} of busy)"
        for name, us in shares.items()))
    # each range's span on the device (its device-side annotation: first
    # kernel start to last kernel end, one stream)
    for name in sorted(host):
        own = [(a, b) for a, b, n in spans if n == name]
        us = sum(b - a for a, b in own) / 1e3
        print(f"[trace] {what}: '{name}' ({host[name]}x on the host, "
              f"{len(own)} device spans): {us / 1e3:.1f} ms on the device "
              f"({us / busy_us:.1%} of busy)")
    if not exclusive:
        return None
    spans = sorted(s for s in spans if s[2] in exclusive)
    starts = [a for a, _, _ in spans]
    parts = dict.fromkeys([*KERNEL_NAMES, *exclusive.values(),
                           *LIBRARY_NAMES, "other"], 0.0)
    kernels_in = dict.fromkeys(exclusive.values(), 0)
    for a, b, name in kernels:
        i = bisect.bisect_right(starts, a) - 1
        inside = i >= 0 and b <= spans[i][1]
        parts[exclusive[spans[i][2]] if inside else part_of(name)] += \
            (b - a) / 1e6
        if inside:
            kernels_in[exclusive[spans[i][2]]] += 1
    busy_ms, wall_ms = busy_us / 1e3, wall_s * 1e3
    print(f"[trace] {what}: idle {1 - busy_ms / wall_ms:.1%} of wall; busy "
          "split (exclusive): " + "; ".join(
              f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in parts.items())
          + f"; {len(spans)} range spans, {len(kernels)} kernels")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, **parts,
            "kernels_in": kernels_in}


def _phase_trace(torch, tf, cfg, params, prompts_t, tokens_t, max_len, name,
                 steps=4):
    """torch.profiler over one prefill and ``steps`` decode steps of the
    kernel run (the profiler's own host cost is in the wall times)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ops import KernelConfig

    kcfg = KernelConfig(True)
    steps = min(steps, tokens_t.shape[1])
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    dev = params["embed"].device
    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, cache = tf.prefill(cfg, params, {"tokens": prompts_t.to(dev)},
                                  max_len, kcfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _trace_line(torch, f"{name} prefill", prof, wall)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                _, cache = tf.decode_step(
                    cfg, params, {"tokens": tokens_t[:, i:i + 1]}, cache,
                    kcfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _trace_line(torch, f"{name} {steps} decode steps", prof, wall)


def _bound(n_bytes, n_ops, ops_per_s):
    """(bound ms, bytes ms, operations ms)."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / ops_per_s * 1e3
    return max(b_ms, o_ms), b_ms, o_ms


def _bound_by(b_ms, o_ms) -> str:
    return "bytes" if b_ms >= o_ms else "operations"


def _phase_time_k2(torch, gen, k2, lora_matmul_ref, shapes):
    """K2 at the serving paths' shapes ((M, K, N, launches), r 16, bf16):
    kernel, plain version and ``torch.addmm(x @ W, x @ A, B, alpha=scale)``
    (no single PyTorch call computes the fused function), each timed by
    ``_graph_ms``. Returns one row per shape.

    At decode (M <= 64) W is read once a launch and fits the 50 MB L2, but on
    the serving path each launch finds its W cold (the step's other 63
    projections come between). So decode rows rotate through copies of
    (x, W, A, B) of more than COLD_BYTES together, kernel, plain version
    and addmm alike: every launch reads inputs last touched a round ago.
    Paths that share a shape share its times (each row its own launches)."""
    rows, timed = [], {}
    for m, k, n, n_launch in shapes:
        if (m, k, n) in timed:
            rows.append(dict(timed[(m, k, n)], launches=n_launch))
            continue
        r = 16
        n_bytes = 2 * (m * k + k * n + k * r + r * n + m * n)
        copies = 1 if m > 64 else COLD_BYTES // n_bytes + 1
        cases = [_lora_case(torch, gen, m, k, n, r, torch.bfloat16)
                 for _ in range(copies)]
        turn = [0]

        def rotate(fn):
            def call():
                turn[0] = (turn[0] + 1) % copies
                return fn(*cases[turn[0]])
            return call

        ms = _graph_ms(torch, rotate(
            lambda x, w, a, b: k2.lora_matmul(x, w, a, b, 2.0)))
        plain = _graph_ms(torch, rotate(
            lambda x, w, a, b: lora_matmul_ref(x, w, a, b, 2.0)))
        lib = _graph_ms(torch, rotate(
            lambda x, w, a, b: torch.addmm(x @ w, x @ a, b, alpha=2.0)))
        n_ops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
        bound, b_ms, o_ms = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
        rows.append({"M": m, "K": k, "N": n, "r": r, "launches": n_launch,
                     "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound, "bound_by": _bound_by(b_ms, o_ms),
                     "footprint": copies * n_bytes})
        timed[(m, k, n)] = rows[-1]
        del cases
    return rows


def _phase_time_k3(torch, gen, k3, flash_attention_ref, b, h, s, d,
                   window=None, causal=True, q_pos=None):
    """K3 at a serving prefill (BH = b x h, S, D, bf16): causal with the
    config's window, non-causal, or with the positions ``q_pos`` (as query
    and key positions), beside the plain version and
    F.scaled_dot_product_attention: kernel and SDPA by ``_graph_ms``, the
    plain version (its (BH, S, S) f32 scores too large to capture 25 times)
    by ``_event_ms``. A window of S or more masks nothing, so SDPA's causal
    call computes the same function; with positions SDPA gets the
    equivalent boolean ``attn_mask``. The bound counts this run's unmasked
    (q, k) pairs, 4 D operations each, and q, k, v, o (and the positions)
    once."""
    import torch.nn.functional as F

    assert window is None or window >= s
    q, k, v = (_randn(torch, gen, (b * h, s, d), 1.0, torch.bfloat16)
               for _ in range(3))
    kw = dict(causal=causal, window=window, q_pos=q_pos, k_pos=q_pos)
    ms = _graph_ms(torch, lambda: k3.flash_attention(q, k, v, **kw))
    for _ in range(3):
        flash_attention_ref(q[None], k[None], v[None], **kw)
    plain = _event_ms(torch, lambda: flash_attention_ref(
        q[None], k[None], v[None], **kw), TIME_REPS)
    q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
    if q_pos is None:
        lib = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
        pairs = s * (s + 1) // 2 if causal else s * s
        pos_bytes = 0
    else:
        mask = q_pos[None, :] <= q_pos[:, None]    # key j kept for query i
        if not causal:
            mask = torch.ones_like(mask)
        lib = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask))
        pairs = int(mask.sum())
        pos_bytes = 2 * 4 * s
    n_bytes = 2 * 4 * b * h * s * d + pos_bytes
    n_ops = 4 * d * b * h * pairs
    bound, b_ms, o_ms = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    return {"BH": b * h, "S": s, "D": d, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound,
            "bound_by": _bound_by(b_ms, o_ms), "pairs": pairs,
            "causal": causal, "positions": q_pos is not None}


def _phase_time_k4(torch, gen, k4, ssd_scan_ref, ssd_scan_grouped_ref, bt,
                   s, hh, p, g, n):
    """K4 at a prefill shape (bf16 x, B, C; f32 dt, A) in both layouts, each
    timed by ``_graph_ms`` (device time alone: ``ms``) and by CUDA events
    around single launches (``event_ms``, as the rows before the redesign
    were; such a pair also holds the wrapper's host work while the card
    waits), beside its plain version (step by step; fewer repetitions, it
    takes S steps). No PyTorch call computes
    the SSD scan, so there is no library time. Each bound counts each input
    and output once (x, y, B, C at 2 bytes, dt, A and the state at 4): in
    the model's layout B and C are read per group, in the flattened one per
    head. The operations are
    those of K4's 64-step chunks (``op_analysis.ssd_flops``: the score tile
    once a group, in the flattened layout once a head; its product with x,
    C against the state and the state update, full 64 x 64 tiles) at the
    bf16 tensor-core rate. Returns {"grouped": row, "flattened": row}."""
    from repro_torch.launch.op_analysis import ssd_flops

    ins = _ssd_grouped_case(torch, gen, bt, s, hh, p, g, n, torch.bfloat16)
    flat = _flattened(torch, *ins)
    bh = bt * hh
    rows = {}
    for layout, fn, plain_fn, args, groups in (
            ("grouped", k4.ssd_scan_grouped, ssd_scan_grouped_ref, ins, g),
            ("flattened", k4.ssd_scan, ssd_scan_ref, flat, hh)):
        for _ in range(3):
            fn(*args)
        events = _event_ms(torch, lambda: fn(*args), TIME_REPS)
        ms = _graph_ms(torch, lambda: fn(*args))
        plain = _event_ms(torch, lambda: plain_fn(*args), 3)
        n_a = hh if layout == "grouped" else bh
        n_bytes = 2 * (2 * bh * s * p + 2 * bt * groups * s * n) + 4 * (
            bh * s + n_a + bh * n * p)
        n_ops = ssd_flops(bt, hh, groups, s, p, n)
        bound, b_ms, o_ms = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
        rows[layout] = {"Bt": bt, "S": s, "H": hh, "P": p, "G": g, "N": n,
                        "ms": ms, "event_ms": events, "plain_ms": plain,
                        "library_ms": None, "bound_ms": bound,
                        "bound_by": _bound_by(b_ms, o_ms), "bytes": n_bytes,
                        "ops": n_ops}
    return rows


def _phase_time_k4_backward(torch, gen, k4, bt, s, hh, p, g, n):
    """K4's backward at a training shape (bf16 x, B, C as views of one
    buffer, dy bf16, dt, A and the state cotangent f32): the kernel by
    ``_graph_ms`` and by events, its plain version
    ``ssd_scan_grouped_bwd_ref`` and autograd's backward through
    ``models/ssm.ssd_chunked`` at the model's chunk (what the plain
    training run executes; the forward's graph kept), each by events. The
    bound counts each input and output once (x, dy, dx, B, C, dB, dC at 2
    bytes, dt, d(dt), A, dA and the state cotangent at 4) and
    ``op_analysis.ssd_backward_flops`` (the score-shaped products once a
    group) at the bf16 tensor-core rate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import ssd_scan_grouped_bwd_ref
    from repro_torch.launch.op_analysis import ssd_backward_flops
    from repro_torch.models.ssm import ssd_chunked

    ins = _ssd_grouped_case(torch, gen, bt, s, hh, p, g, n, torch.bfloat16)
    dy = _randn(torch, gen, (bt, s, hh, p), 1.0, torch.bfloat16)
    dh = _randn(torch, gen, (bt, hh, n, p), 1.0, torch.float32)

    def kernel():
        return k4.ssd_scan_grouped_backward(*ins, dy, dh)

    before = k4.ssd_scan.backward_launches   # timing launches do not count
    for _ in range(2):
        kernel()
    events = _event_ms(torch, kernel, 5)
    ms = _graph_ms(torch, kernel, reps=5, rounds=3)
    k4.ssd_scan.backward_launches = before
    plain = _event_ms(torch, lambda: ssd_scan_grouped_bwd_ref(*ins, dy, dh),
                      3)
    chunk = next(get_config(a).ssm.chunk_size for a, _, _ in TRAIN_SSM_RUNS)
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    y, h = ssd_chunked(*leaves, chunk)
    dht = dh.transpose(-1, -2)   # ssd_chunked's state is (P, N)
    chunked = _event_ms(torch, lambda: torch.autograd.grad(
        (y, h), leaves, (dy, dht), retain_graph=True), 3)
    del y, h, leaves
    torch.cuda.empty_cache()
    bh = bt * hh
    n_bytes = 2 * (3 * bh * s * p + 4 * bt * g * s * n) + 4 * (
        2 * bh * s + 2 * hh + bh * n * p)
    n_ops = ssd_backward_flops(bt, hh, g, s, p, n)
    bound, b_ms, o_ms = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    return {"Bt": bt, "S": s, "H": hh, "P": p, "G": g, "N": n, "ms": ms,
            "event_ms": events, "plain_ms": plain, "chunked_ms": chunked,
            "chunk": chunk, "library_ms": None, "bound_ms": bound,
            "bound_by": _bound_by(b_ms, o_ms), "bytes": n_bytes,
            "ops": n_ops,
            "issued_ops": _k4_bwd_issued_ops(torch, k4, bt, s, hh, g, n)}


def _k4_bwd_issued_ops(torch, k4, bt, s, hh, g, n) -> int:
    """The operations K4's bf16 backward issues on the tensor cores (2 a
    multiply-add; P and N padded as its tiles pad them, to 64 and to 64 or
    128; hi + lo halves counted as two products): the two state scans'
    updates (every chunk but one, NP x 64 x 64 each), and in each
    gradient block S^T once (64 x 64 x NP), per head Q^T (64^3), B G, M^T
    dy, x G^T and dy H^T, per run (sum dS^T) C and (sum dS) B."""
    from repro_torch.kernels.ref import SSD_CHUNK

    c, npad = SSD_CHUNK, k4.state_rows(n)
    nc = -(-s // c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    run, rpg = k4.backward_runs(bt, s, hh, g, sms)
    scans = 2 * bt * hh * max(nc - 1, 0) * 2 * npad * c * c
    per_head = c ** 3 + 2 * c * c * npad + 2 * c ** 3 + 4 * c * npad * c
    per_run = c * c * npad + 4 * c * npad * c
    return 2 * (scans + bt * nc * (g * rpg * per_run + hh * per_head))


def _phase_time_k3_backward(torch, gen, k3, bh, s, d, mask):
    """K3's backward at a training shape under its mask (bf16 q, k, v, dO;
    ``_k3_train_shapes``' mask: causal or not, a window, an image span's
    positions; m and l from the forward): the kernel by ``_graph_ms`` and
    by events, its
    plain version ``flash_attention_bwd_ref``, the route the Function took
    before the kernel (autograd through ``flash_attention_ref``: its
    forward again and that forward's backward) and
    ``F.scaled_dot_product_attention``'s backward (the library yardstick:
    ``torch.autograd.grad`` of its output, the graph kept; with positions
    given the equivalent boolean ``attn_mask``, as ``_phase_time_k3``),
    each by events. The bound counts this run's unmasked (q, k) pairs, 10
    D operations each (``op_analysis.attention_backward_flops``), and q, k,
    v, dO, dq, dk, dv at 2 bytes and m, l (and the positions) at 4 once."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)
    from repro_torch.launch.op_analysis import attention_backward_flops

    kw = _k3_mask_kwargs(torch, mask, s, gen.device)
    q, k, v, do = (_randn(torch, gen, (bh, s, d), 1.0, torch.bfloat16)
                   for _ in range(4))
    before = (k3.flash_attention.launches,
              k3.flash_attention_backward.launches)
    _, m, l = k3.flash_attention(q, k, v, stats=True, **kw)

    def kernel():
        return k3.flash_attention_backward(q, k, v, m, l, do, **kw)

    for _ in range(2):
        kernel()
    events = _event_ms(torch, kernel, 5)
    ms = _graph_ms(torch, kernel)
    # timing launches do not count
    k3.flash_attention.launches, k3.flash_attention_backward.launches = \
        before
    plain = _event_ms(torch, lambda: flash_attention_bwd_ref(
        q[None], k[None], v[None], m[None], l[None], do[None], **kw), 3)

    def autograd_plain():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_ref(*(t[None] for t in leaves), **kw)[0]
        return torch.autograd.grad(o, leaves, do)

    old = _event_ms(torch, autograd_plain, 3)
    leaves = [t.reshape(1, bh, s, d).clone().requires_grad_(True)
              for t in (q, k, v)]
    if mask["window"] is not None and mask["window"] < s:
        _fail(f"[time] K3 backward: SDPA has no window ({mask['window']} < "
              f"S {s})")
    if "q_pos" in kw:
        pos = kw["q_pos"]
        o = F.scaled_dot_product_attention(
            *leaves, attn_mask=pos[None, :] <= pos[:, None])
    else:
        o = F.scaled_dot_product_attention(*leaves,
                                           is_causal=mask["causal"])
    do4 = do.reshape(1, bh, s, d)
    for _ in range(2):
        torch.autograd.grad(o, leaves, do4, retain_graph=True)
    lib = _event_ms(torch, lambda: torch.autograd.grad(
        o, leaves, do4, retain_graph=True), TIME_REPS)
    del o, leaves
    torch.cuda.empty_cache()
    pos_bytes = 2 * 4 * s if "q_pos" in kw else 0
    n_bytes = 2 * 7 * bh * s * d + 4 * 2 * bh * s + pos_bytes
    n_ops = attention_backward_flops(bh, s, s, d, **kw)
    bound, b_ms, o_ms = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    pairs = n_ops // (10 * d * bh)
    return {"BH": bh, "S": s, "D": d, "ms": ms, "event_ms": events,
            "plain_ms": plain, "autograd_plain_ms": old, "library_ms": lib,
            "bound_ms": bound, "bound_by": _bound_by(b_ms, o_ms),
            "bytes": n_bytes, "ops": n_ops, "pairs": pairs,
            # the tensor-core operations the kernel issues: 24 D a pair
            # (S and dP in each of its three passes, the hi and lo halves
            # of P and dS in dV, dK and dQ), 2.4 times the bound's count;
            # the position path visits every 64 x 64 tile pair
            "issued_ops": 24 * d * bh * (pairs if "q_pos" not in kw
                                         else (-(-s // 64) * 64) ** 2)}


def _k2_shapes(launches=None):
    """K2's timed shapes and launch counts on each serving path: llama2-7b's
    q / v projection (K = N = 4096) at prefill (M = 8 x 1024) and decode
    (M = 8); mamba2-370m's and zamba2-2.7b's wx projection (K = d, N =
    d_inner; out_proj moves the same bytes and operations transposed) at
    prefill and decode; mixtral-8x7b's and DENSE_RUNS' q and v at prefill
    and decode (``_k2_projections``); the training paths' forward shapes
    (``_k2_train_rows``), with every K2 launch of the path's phase (None
    before the serving runs; a training path's forward launches over its
    timed steps)."""
    from repro_torch.configs import get_config

    def count(tag, i, share=1):
        return None if launches is None else int(launches[tag][i] * share)

    rows = {"prefill": (SERVE_BATCH * SERVE_PROMPT, 4096, 4096,
                        count("serve", 0)),
            "decode": (SERVE_BATCH, 4096, 4096, count("serve", 1))}
    for tag, (arch, batch, prompt, _, _) in FAMILY_RUNS.items():
        cfg = get_config(arch)
        d, di = cfg.d_model, cfg.ssm.d_inner(cfg.d_model)
        name = arch.split("-")[0]
        rows[f"{name}-prefill"] = (batch * prompt, d, di, count(tag, 0))
        rows[f"{name}-decode"] = (batch, d, di, count(tag, 1))
    # mixtral-8x7b's and the last five archs' adapted projections: one
    # launch each a layer a forward, the share of a phase's count
    serving = {"mixtral": (MOE_RUN[0], "serve-moe")}
    serving.update((name, (run[0], f"serve-{name}"))
                   for name, run in DENSE_RUNS.items())
    for name, (arch, tag) in serving.items():
        for proj, (k, n, share) in _k2_projections(get_config(arch)).items():
            for phase, m, i in (("prefill", SERVE_BATCH * SERVE_PROMPT, 0),
                                ("decode", SERVE_BATCH, 1)):
                rows[f"{name}{proj}-{phase}"] = (m, k, n,
                                                 count(tag, i, share))
    # the training paths' forwards (and remat recomputes)
    for name, (m, k, n, tag, share) in _k2_train_rows().items():
        rows[f"{name}-train"] = (m, k, n, count(tag, 0, share))
    return rows


def _k2_projections(cfg):
    """K2's adapted projections of an attention config, q (N = heads x
    head_dim) and v (N = KV heads x head_dim): row suffix -> (K = d, N,
    ``share``), the fraction of the config's K2 launches (forward and dx
    alike) at that shape; one row, suffix "", where q and v have one
    width."""
    from fractions import Fraction

    width = {"q": cfg.num_heads * cfg.head_dim,
             "v": cfg.num_kv_heads * cfg.head_dim}
    targets = cfg.lora.targets
    if set(targets) != set(width):
        _fail(f"{cfg.name} adapts {targets}, not q and v")
    out = {}
    for proj in targets:
        share = Fraction(list(width.values()).count(width[proj]),
                         len(targets))
        out["" if share == 1 else f"-{proj}"] = (cfg.d_model, width[proj],
                                                 share)
    return out


def _train_paths():
    """The training paths K2's and K3's backward rows are taken from,
    beyond [train] and [train-ssm]: name -> (tag, arch, seq, batch)."""
    paths = {arch.rsplit("-", 1)[0]: (tag, arch, seq, batch)
             for tag, (arch, seq, batch, _) in TRAIN_FAM_RUNS.items()}
    paths.update((name, (f"train-{name}", run[0]) + TRAIN_RUN[1:])
                 for name, run in DENSE_RUNS.items())
    return paths


def _k2_train_rows():
    """K2's forward shapes on [train-vlm]'s, [train-audio]'s, [train-moe]'s
    and DENSE_RUNS' training paths, one row per adapted projection width
    (``_k2_projections``): name -> (M, K = d, N, tag, share). Fails if a
    shape is not in K2_GRAD_SHAPES."""
    from repro_torch.configs import get_config

    out = {}
    for name, (tag, arch, seq, batch) in _train_paths().items():
        cfg = get_config(arch)
        for proj, (k, n, share) in _k2_projections(cfg).items():
            shape = (batch * seq, k, n, cfg.lora.rank)
            if shape not in K2_GRAD_SHAPES:
                _fail(f"[{tag}] K2 runs at {shape}, not in K2_GRAD_SHAPES")
            out[name + proj] = shape[:3] + (tag, share)
    return out


def _before(name) -> str:
    """A row's time before its kernel's redesign, where one was taken."""
    us = BEFORE_US.get(name)
    return "not timed" if us is None else f"{us:,.1f} us"


# ---------------------------------------------------------------------------
# Training: the autograd Functions, [train-ref], [train], [elastic]
# ---------------------------------------------------------------------------

# A gradient of K2's Function, K3's or K4's against autograd through the
# plain version: elementwise |got - want| <= rtol |want| + atol max|want|.
# K2's dA and dB are sums over M (8,192 terms at the train shape) taken in
# another order on each side, so a value near 0 carries an error of the
# tensor's scale, not its own; f32 1e-4 / 1e-5, bf16 one rounding of the
# f32 result (2^-7) / 2^-9. K3's backward kernel sums dK and dV over the
# queries and dQ over the keys in another order, and takes P and dS as hi
# + lo bf16 halves; the plain routes run in f32 and round once. K4's backward
# kernel sums the chunked scan in f32 in another order than the plain
# version's step-by-step recurrence and rounds each gradient once; the
# plain route in bf16 also rounds each head's dB / dC before its group's
# sum.
GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -9)}


def _grad_close(torch, what, got, want, dt, scale=None) -> float:
    rtol, atol = GRAD_TOL[dt]
    return _close(torch, what, got, want, rtol,
                  atol * float(want.float().abs().max()), scale)


def _phase_k2_grad(torch, gen, k2, lora_matmul_ref) -> tuple:
    """[k2-grad]: K2's Function (forward K2; dx by K2 on W^T, B^T, A^T;
    dA, dB f32 rank-r products) against torch.autograd through the plain
    version on the card, at K2_GRAD_SHAPES, f32 and bf16; then the guard:
    a direct launch under grad raises. Returns the largest |err| of y and
    of dx."""
    max_err = max_dx = 0.0
    for m, k, n, r in K2_GRAD_SHAPES:
        for dt in ("float32", "bfloat16"):
            x, w, a, b = _lora_case(torch, gen, m, k, n, r,
                                    getattr(torch, dt))
            dy = _randn(torch, gen, (m, n), 1.0, getattr(torch, dt))
            before = (k2.lora_matmul.launches,
                      k2.lora_matmul.backward_launches)
            ins = [t.clone().requires_grad_(True) for t in (x, a, b)]
            y = k2.LoRAMatmul.apply(ins[0], w, ins[1], ins[2], 2.0)
            got = torch.autograd.grad(y, ins, dy)
            torch.cuda.synchronize()
            after = (k2.lora_matmul.launches,
                     k2.lora_matmul.backward_launches)
            # comparison launches do not count
            k2.lora_matmul.launches, k2.lora_matmul.backward_launches = before
            if (after[0] - before[0], after[1] - before[1]) != (1, 1):
                _fail(f"[k2-grad] {(m, k, n, r)} {dt}: {after[0] - before[0]}"
                      f" forward and {after[1] - before[1]} backward K2 "
                      "launches, expected 1 and 1")
            ref_ins = [t.clone().requires_grad_(True) for t in (x, a, b)]
            yr = lora_matmul_ref(ref_ins[0], w, ref_ins[1], ref_ins[2], 2.0)
            want = torch.autograd.grad(yr, ref_ins, dy)
            err = _close(torch, f"[k2-grad] y {dt} {(m, k, n, r)}", y, yr,
                         *K2_TOL[dt])
            errs = [_grad_close(torch, f"[k2-grad] {name} {dt} "
                                f"{(m, k, n, r)}", g, wnt, dt)
                    for name, g, wnt in zip(("dx", "dA", "dB"), got, want)]
            max_err, max_dx = max(max_err, err), max(max_dx, errs[0])
            print(f"[k2-grad] {dt} (M, K, N, r) = {(m, k, n, r)}: max |err| "
                  f"y {err:.3e} (rtol/atol {K2_TOL[dt]}), dx {errs[0]:.3e}, "
                  f"dA {errs[1]:.3e}, dB {errs[2]:.3e} (rtol, atol x "
                  f"max|want| {GRAD_TOL[dt]}); 1 forward + 1 backward K2 "
                  "launch")
            del x, w, a, b, dy, y, got, want, yr, ins, ref_ins
    x, w, a, b = _lora_case(torch, gen, 64, 128, 128, 16, torch.bfloat16)
    try:
        k2.lora_matmul(x.requires_grad_(True), w, a, b, 2.0)
    except RuntimeError as e:
        print(f"[k2-grad] a direct launch under grad raises: {e}")
    else:
        _fail("[k2-grad] a direct K2 launch on a tensor that requires grad "
              "did not raise")
    return max_err, max_dx


def _attention_grads(torch, ops, ins, do, use_cuda, **mask):
    leaves = [t.clone().requires_grad_(True) for t in ins]
    o = ops.attention(*leaves, kcfg=ops.KernelConfig(use_cuda), **mask)
    return o, torch.autograd.grad(o, leaves, do)


def _k3_grad_cases(torch, dev):
    """[k3-grad]'s masks through ops.attention at (B, S) = (2, 200): causal,
    a window of 64, non-causal, and positions q_pos = k_pos - 8 (causal:
    queries 0-7 keep no key, the position path's rows without a key)."""
    ar = torch.arange(200, dtype=torch.int32, device=dev)
    return ({"causal": True}, {"causal": True, "window": 64},
            {"causal": False}, {"causal": True, "q_pos": ar - 8,
                                "k_pos": ar})


def _k3_train_shapes():
    """K3's backward at each training path's shape and mask: [train]'s,
    [train-ssm]'s hybrid and ``_train_paths``' ([train-vlm]'s,
    [train-audio]'s, [train-moe]'s and DENSE_RUNS'): name -> (BH, S, D,
    mask), the mask as ``_k3_mask_kwargs`` takes it: causal, the config's
    window, and for qwen2-vl the image span whose temporal stream is q_pos
    = k_pos."""
    from repro_torch.configs import get_config

    runs = [("llama2", TRAIN_RUN),
            ("zamba2", next(r for r in TRAIN_SSM_RUNS
                            if r[0] == "zamba2-2.7b"))]
    runs += [(name, path[1:]) for name, path in _train_paths().items()]
    out = {}
    for name, (arch, seq, batch) in runs:
        cfg = get_config(arch)
        mask = {"causal": cfg.causal, "window": cfg.sliding_window}
        if cfg.m_rope:
            mask["span"] = VLM_RUN[3]
        out[name] = (batch * cfg.num_heads, seq, cfg.head_dim, mask)
    return out


def _k3_mask_kwargs(torch, mask, s, dev) -> dict:
    """K3's mask keywords for ``_k3_train_shapes``' mask at length ``s``:
    causal and window, and with an image span q_pos = k_pos = the temporal
    stream of ``make_mrope_positions`` (int32 on ``dev``), as
    ``blocks.mask_positions`` gives the model's attention."""
    from repro_torch.models.frontends import make_mrope_positions

    kw = {"causal": mask["causal"], "window": mask["window"]}
    if "span" in mask:
        pos = make_mrope_positions(1, s, mask["span"])[0, :, 0]
        pos = torch.from_numpy(pos.copy()).to(dev)
        kw.update(q_pos=pos, k_pos=pos)
    return kw


def _mask_label(mask) -> str:
    if "span" in mask:
        return f"causal by the {mask['span']} image span's positions"
    label = "causal" if mask["causal"] else "non-causal"
    return label + (f", window {mask['window']}" if mask["window"] else "")


def _phase_k3_grad(torch, gen, k3) -> tuple:
    """[k3-grad]: K3's Function through ops.attention (GQA: 8 query heads
    over 2 K / V heads, repeated before K3) at (2, 200, 8, 2, 128), f32 and
    bf16, each of ``_k3_grad_cases``: one forward launch (with the row
    statistics) and one launch of K3's backward kernel, the plain attention
    never called on the card's route; the forward within K3_TOL and dq, dk,
    dv within GRAD_TOL of autograd through the plain route. Then the
    backward kernel alone at the training shapes under their masks
    (``_k3_train_shapes``: causal, non-causal, a window, an image span's
    positions; bf16 and f32) against its plain version
    ``flash_attention_bwd_ref`` and against autograd through
    ``flash_attention_ref``, every gradient in its input's dtype.
    Comparison launches do not count. Returns (the largest |err| of the
    forward, {shape name: the largest |err| of the kernel's bf16 gradients
    against flash_attention_bwd_ref})."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)

    max_err = 0.0
    for dt in ("float32", "bfloat16"):
        for mask in _k3_grad_cases(torch, gen.device):
            dtype = getattr(torch, dt)
            ins = [_randn(torch, gen, (2, 200, h, 128), 1.0, dtype)
                   for h in (8, 2, 2)]
            do = _randn(torch, gen, (2, 200, 8, 128), 1.0, dtype)
            label = {k: v for k, v in mask.items() if k not in ("q_pos",
                                                               "k_pos")}
            if "q_pos" in mask:
                label["q_pos"] = "k_pos - 8"
            before = (k3.flash_attention.launches,
                      k3.flash_attention_backward.launches)
            plain = _count_plain_attention(k3)
            try:
                o, got = _attention_grads(torch, ops, ins, do, True, **mask)
                torch.cuda.synchronize()
            finally:
                k3.flash_attention_ref = plain.plain
            launched = (k3.flash_attention.launches - before[0],
                        k3.flash_attention_backward.launches - before[1])
            (k3.flash_attention.launches,
             k3.flash_attention_backward.launches) = before
            if launched != (1, 1) or plain.n:
                _fail(f"[k3-grad] {dt} {label}: K3 forward / backward "
                      f"launched {launched} times, the plain attention "
                      f"{plain.n} times; expected (1, 1) and 0")
            want_o, want = _attention_grads(torch, ops, ins, do, False,
                                            **mask)
            # dk and dv sum each K / V head's gradient over the query heads
            # that share it (the repeat's backward), each term rounded to
            # the inputs' dtype on both routes: so a term may be one
            # rounding apart, and a sum of terms that cancel is held to
            # the terms' magnitudes (the plain route's per-head gradients)
            # the terms themselves (K / V repeated first, so no sum): the
            # Function's within GRAD_TOL of the plain route's
            rep = ins[0].shape[2] // ins[1].shape[2]
            split = [ins[0]] + [t.repeat_interleave(rep, dim=2)
                                for t in ins[1:]]
            _, heads = _attention_grads(torch, ops, split, do, False, **mask)
            _, got_heads = _attention_grads(torch, ops, split, do, True,
                                            **mask)
            torch.cuda.synchronize()
            (k3.flash_attention.launches,
             k3.flash_attention_backward.launches) = before
            head_errs = [_grad_close(torch, f"[k3-grad] d{n} a head {dt} "
                                     f"{label}", g, w, dt)
                         for n, g, w in zip("kv", got_heads[1:], heads[1:])]
            terms = [None] + [g.float().abs().unflatten(2, (-1, rep)).sum(3)
                              for g in heads[1:]]
            rtol, atol = GRAD_TOL[dt]
            past = sum(int(((g.float() - w.float()).abs() > rtol
                            * w.float().abs() + atol
                            * float(w.float().abs().max())).sum())
                       for g, w in zip(got[1:], want[1:]))
            err = _close(torch, f"[k3-grad] o {dt} {label}", o, want_o,
                         *K3_TOL[dt])
            errs = [_grad_close(torch, f"[k3-grad] d{n} {dt} {label}", g, w,
                                dt, scale)
                    for n, g, w, scale in zip("qkv", got, want, terms)]
            max_err = max(max_err, err)
            print(f"[k3-grad] {dt} (B, S, H, KV, D) = (2, 200, 8, 2, 128) "
                  f"{label}: forward max |err| {err:.3e} (rtol/atol "
                  f"{K3_TOL[dt]}); dq, dk, dv "
                  f"{', '.join(f'{e:.3e}' for e in errs)} (rtol, atol x "
                  f"max|want| {GRAD_TOL[dt]}; dk, dv rtol x the {rep} "
                  f"heads' summed magnitudes: {past} elements past rtol x "
                  f"|want|; each head's dk, dv before the sum "
                  f"{', '.join(f'{e:.3e}' for e in head_errs)}) against "
                  "autograd through the plain route; 1 forward + 1 "
                  "backward launch, no plain attention")
    bwd_errs = {}
    for name, (bh, s, d, mask) in _k3_train_shapes().items():
        kw = _k3_mask_kwargs(torch, mask, s, gen.device)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            q, k, v, do = (_randn(torch, gen, (bh, s, d), 1.0, dtype)
                           for _ in range(4))
            before = (k3.flash_attention.launches,
                      k3.flash_attention_backward.launches)
            _, m, l = k3.flash_attention(q, k, v, stats=True, **kw)
            got = k3.flash_attention_backward(q, k, v, m, l, do, **kw)
            torch.cuda.synchronize()
            launched = k3.flash_attention_backward.launches - before[1]
            (k3.flash_attention.launches,
             k3.flash_attention_backward.launches) = before
            if launched != 1 or any(g.dtype != dtype or g.shape != t.shape
                                    for g, t in zip(got, (q, k, v))):
                _fail(f"[k3-grad] {name} {dt}: {launched} launches, "
                      f"gradients {[(g.dtype, tuple(g.shape)) for g in got]}")
            want = flash_attention_bwd_ref(q[None], k[None], v[None],
                                           m[None], l[None], do[None], **kw)
            errs = [_grad_close(torch, f"[k3-grad] {name} d{n} {dt}", g,
                                w[0], dt)
                    for n, g, w in zip("qkv", got, want)]
            del want
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref_o = flash_attention_ref(*(t[None] for t in leaves), **kw)[0]
            auto = torch.autograd.grad(ref_o, leaves, do)
            del ref_o, leaves
            errs_auto = [_grad_close(torch, f"[k3-grad] {name} d{n} {dt} "
                                     "(autograd)", g, w, dt)
                         for n, g, w in zip("qkv", got, auto)]
            if dt == "bfloat16":
                bwd_errs[name] = max(errs)
            print(f"[k3-grad] K3 backward at {name}'s training shape (BH, "
                  f"S, D) = {(bh, s, d)} {_mask_label(mask)} {dt}: max "
                  f"|err| dq, dk, dv "
                  f"{', '.join(f'{e:.3e}' for e in errs)} against "
                  f"flash_attention_bwd_ref, "
                  f"{', '.join(f'{e:.3e}' for e in errs_auto)} against "
                  f"autograd through flash_attention_ref (rtol, atol x "
                  f"max|want| {GRAD_TOL[dt]})")
            del q, k, v, do, m, l, got, auto
            torch.cuda.empty_cache()
    return max_err, bwd_errs


def _ssd_train_layouts():
    """K4 on [train-ssm]'s runs, in the model's layout: arch -> (Bt, S, H,
    P, G, N)."""
    return {arch: _ssd_layout(arch, batch, seq)
            for arch, seq, batch in TRAIN_SSM_RUNS}


def _phase_k4_grad(torch, gen, k4) -> tuple:
    """[k4-grad]: K4's Function through ops.ssd on the model's layout (x,
    B, C views of one buffer, G 2 over H 4), forward K4 and backward K4's
    backward kernel, against autograd through the plain version (step by
    step): y and the state within K4's tolerance, the input gradients
    within GRAD_TOL, one launch of each. Then the backward kernel alone
    against its full-size plain version ``ssd_scan_grouped_bwd_ref`` at
    [train-ssm]'s shapes (mamba2-370m's and zamba2-2.7b's), f32 and bf16,
    with a state cotangent: every gradient within GRAD_TOL and in its
    input's dtype. Comparison launches do not count. Returns the largest
    |err| of y and of the backward kernel's dx."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_grouped_bwd_ref

    bt, s, hh, p, g, n = 2, 100, 4, 64, 2, 64
    max_err = max_dx = 0.0
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        width = hh * p + 2 * g * n
        buf = _randn(torch, gen, (bt, s, width), 1.0, dtype)
        dtt = torch.rand((bt, s, hh), generator=gen, device=gen.device) * 0.5
        A = -torch.rand((hh,), generator=gen, device=gen.device)
        dy = _randn(torch, gen, (bt, s, hh, p), 1.0, dtype)
        dh = _randn(torch, gen, (bt, hh, n, p), 1.0, torch.float32)
        outs = []
        for use_cuda in (True, False):
            xbc, d_t, a_t = (t.clone().requires_grad_(True)
                             for t in (buf, dtt, A))
            x = xbc[..., :hh * p].unflatten(-1, (hh, p))
            B = xbc[..., hh * p:hh * p + g * n].unflatten(-1, (g, n))
            C = xbc[..., hh * p + g * n:].unflatten(-1, (g, n))
            before = (k4.ssd_scan.launches, k4.ssd_scan.backward_launches)
            y, h = ops.ssd(x, d_t, a_t, B, C,
                           kcfg=ops.KernelConfig(use_cuda))
            grads = torch.autograd.grad((y, h), (xbc, d_t, a_t), (dy, dh))
            torch.cuda.synchronize()
            launched = (k4.ssd_scan.launches - before[0],
                        k4.ssd_scan.backward_launches - before[1])
            k4.ssd_scan.launches, k4.ssd_scan.backward_launches = before
            if launched != (int(use_cuda),) * 2:
                _fail(f"[k4-grad] {dt}: K4 forward / backward launched "
                      f"{launched} times")
            outs.append((y, h, grads))
        (y, h, got), (want_y, want_h, want) = outs
        err = _close(torch, f"[k4-grad] y {dt}", y, want_y, *K4_TOL[dt])
        _close(torch, f"[k4-grad] state {dt}", h, want_h,
               *K4_TOL["float32"])
        errs = [_grad_close(torch, f"[k4-grad] d{nm} {dt}", a, b, dt)
                for nm, a, b in zip(("xBC", "dt", "A"), got, want)]
        max_err = max(max_err, err)
        print(f"[k4-grad] {dt} (Bt, S, H, P, G, N) = {(bt, s, hh, p, g, n)}, "
              f"x / B / C views of one buffer: y max |err| {err:.3e} (rtol/"
              f"atol {K4_TOL[dt]}); d(xBC), d(dt), dA "
              f"{', '.join(f'{e:.3e}' for e in errs)} (rtol, atol x "
              f"max|want| {GRAD_TOL[dt]}) against autograd through the "
              "plain version; 1 forward + 1 backward K4 launch")
    names = ("dx", "d(dt)", "dA", "dB", "dC")
    for arch, shape in _ssd_train_layouts().items():
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            ins = _ssd_grouped_case(torch, gen, *shape, dtype)
            bt, s, hh, p, g, n = shape
            dy = _randn(torch, gen, (bt, s, hh, p), 1.0, dtype)
            dh = _randn(torch, gen, (bt, hh, n, p), 1.0, torch.float32)
            before = k4.ssd_scan.backward_launches
            got = k4.ssd_scan_grouped_backward(*ins, dy, dh)
            torch.cuda.synchronize()
            launched = k4.ssd_scan.backward_launches - before
            k4.ssd_scan.backward_launches = before
            if launched != 1:
                _fail(f"[k4-grad] {arch} {dt}: K4's backward launched "
                      f"{launched} times")
            want = ssd_scan_grouped_bwd_ref(*ins, dy, dh)
            kinds = (dtype, torch.float32, torch.float32, dtype, dtype)
            if any(a.dtype != k or a.shape != b.shape
                   for a, b, k in zip(got, want, kinds)):
                _fail(f"[k4-grad] {arch} {dt}: gradients "
                      f"{[(a.dtype, tuple(a.shape)) for a in got]}")
            errs = [_grad_close(torch, f"[k4-grad] {arch} {nm} {dt}", a, b,
                                dt) for nm, a, b in zip(names, got, want)]
            max_dx = max(max_dx, errs[0])
            print(f"[k4-grad] K4 backward at {arch}'s training shape (Bt, "
                  f"S, H, P, G, N) = {shape} {dt}, x / B / C views of one "
                  "buffer: max |err| "
                  + ", ".join(f"{nm} {e:.3e}" for nm, e in zip(names, errs))
                  + f" against ssd_scan_grouped_bwd_ref (rtol, atol x "
                  f"max|want| {GRAD_TOL[dt]})")
            del ins, dy, dh, got, want
            torch.cuda.empty_cache()
    return max_err, max_dx


def _lora_movement(torch, before, after):
    d = [(a.double() - b.double()) for a, b in zip(after, before)]
    return (float(sum(x.abs().sum() for x in d)),
            float(sum(x.square().sum() for x in d)))


def train_ref_run(torch, dev, microbatches: int,
                  arch: str = TRAIN_REF_ARCH) -> dict:
    """[train-ref]'s, [train-ssm-ref]'s and [train-fam-ref]'s port run:
    TRAIN_REF_STEPS steps of make_train_step on ``arch``'s smoke config
    with ``KernelConfig(use_cuda=True)`` on ``dev`` (the CPU runs the plain
    versions), each on ``train_ref_batch``'s batch. Returns TRAIN_REF's
    keys and ``base_unchanged``."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.train.step import init_opt_state, make_train_step
    from repro_torch.utils.partition import is_lora_path, partition_by_path

    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(**TRAIN_REF_RUNS[microbatches])
    params = convert.model_params(
        convert.random_model_params(cfg, TRAIN_REF_SEED), cfg, dev)

    def split(p):
        return (partition_by_path(p, is_lora_path)[0],
                partition_by_path(p, lambda q: not is_lora_path(q))[0])

    lora0, base0 = ([x.clone() for x in xs] for xs in split(params))
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg, KernelConfig(use_cuda=True))
    rows = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(TRAIN_REF_STEPS):
        params, opt, m = step(params, opt, train_ref_batch(
            np, cfg, tcfg.global_batch, tcfg.seq_len, i))
        for k in rows:
            rows[k].append(float(getattr(m, k)))
    lora, base = split(params)
    move_abs, move_sq = _lora_movement(torch, lora0, lora)
    return {**{k: tuple(v) for k, v in rows.items()}, "move_abs": move_abs,
            "move_sq": move_sq,
            "base_unchanged": all(torch.equal(a, b) and a.grad is None
                                  for a, b in zip(base, base0))}


def _phase_train_ref(torch, dev, kernels, tag="train-ref",
                     arch=TRAIN_REF_ARCH, refs=None):
    """[train-ref] / [train-ssm-ref] / [train-fam-ref]: train_ref_run on
    the card for every TRAIN_REF_RUNS entry on ``arch``'s smoke config
    against the JAX constants ``refs`` (TRAIN_REF unless given). Every
    kernel of the config's training path must launch: K2 forward and
    backward, K3 where it has attention (and K3's backward), K4 and K4's
    backward where it has Mamba2 layers; under M-RoPE every K3 launch
    takes the batch's positions."""
    import numpy as np

    from repro_torch.configs import get_smoke_config

    k2, k3, k4 = kernels
    cfg = get_smoke_config(arch)
    has_k3 = cfg.arch_type != "ssm"
    has_k4 = cfg.arch_type in ("ssm", "hybrid")
    names = ("K2 forward", "K2 backward", "K3", "K4", "K4 backward",
             "K3 backward")
    for mb, want in (TRAIN_REF if refs is None else refs).items():
        _reset_counts(k2, k3, k4)
        got = train_ref_run(torch, dev, mb, arch)
        torch.cuda.synchronize()
        counts = _train_counts(k2, k3, k4)
        needed = (True, True, has_k3, has_k4, has_k4, has_k3)
        if any(bool(c) != need for c, need in zip(counts, needed)):
            _fail(f"[{tag}] {arch} microbatches {mb}: launches "
                  + ", ".join(f"{k} {c}" for k, c in zip(names, counts))
                  + f"; each of {[k for k, n in zip(names, needed) if n]} "
                  "must run, and no other")
        with_pos = k3.flash_attention.position_launches
        if with_pos != (counts[2] if cfg.m_rope else 0):
            _fail(f"[{tag}] {arch} microbatches {mb}: {with_pos} of "
                  f"{counts[2]} K3 launches with positions")
        if not got["base_unchanged"]:
            _fail(f"[{tag}] {arch} microbatches {mb}: a base leaf changed "
                  "or holds a .grad")
        worst = {}
        for key, rtol in TRAIN_REF_RTOL.items():
            g = np.asarray(got[key], np.float64)
            w = np.asarray(want[key], np.float64)
            rel = float(np.max(np.abs(g - w) / np.abs(w)))
            worst[key] = rel
            if not rel <= rtol:
                _fail(f"[{tag}] {arch} microbatches {mb}: {key} "
                      f"{got[key]} against JAX's {want[key]} (relative "
                      f"{rel:.2e} > {rtol})")
        print(f"[{tag}] {arch} smoke config, f32, {TRAIN_REF_RUNS[mb]}: "
              f"{TRAIN_REF_STEPS} steps on the card, losses "
              f"{', '.join(f'{x:.6f}' for x in got['loss'])}; largest "
              "relative distance from JAX's: " + ", ".join(
                  f"{k} {v:.2e} (bound {TRAIN_REF_RTOL[k]})"
                  for k, v in worst.items())
              + "; base leaves bit-unchanged; launches " + ", ".join(
                  f"{k} {c}" for k, c in zip(names, counts) if c)
              + (f" ({with_pos} K3 with positions)" if with_pos else ""))


# ``_bits_digest``'s multipliers c_i = (i k + b) | 1, two sets (int64
# arithmetic, which wraps mod 2^64)
DIGEST_KEYS = ((-7046029254386353131, 7145368468934828057),
               (2685821657736338717, 461845907))


def _bits_digest(torch, xs, chunk: int = 1 << 25) -> list:
    """Each tensor's bits folded on its device into two 64-bit sums: the
    tensor read as words w_i of its element size, sum_i w_i c_i mod 2^64
    for c_i = (i k + b) | 1 under each of DIGEST_KEYS. Every c_i is odd, so
    invertible mod 2^64: a change to any one word moves both sums, and two
    independent sets leave a change of several words unseen with a chance
    near 2^-128. It replaces a host copy of the base weights, which moved
    about 2 GB/s (mixtral-8x7b's 47 GB in 23.1 s beside an NVIDIA H100 80GB
    HBM3, 700.00 W). Returns one (2,) int64 tensor a tensor, on its
    device."""
    words = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for x in xs:
        w = x.detach().contiguous().reshape(-1).view(words[x.element_size()])
        acc = torch.zeros(2, dtype=torch.int64, device=w.device)
        for start in range(0, w.numel(), chunk):
            part = w[start:start + chunk].long()
            i = torch.arange(start, start + part.numel(), dtype=torch.int64,
                             device=w.device)
            for j, (k, b) in enumerate(DIGEST_KEYS):
                acc[j] += (part * ((i * k + b) | 1)).sum()
        out.append(acc)
    return out


def _grad_distance(torch, a, b) -> tuple:
    """(L2 norm of a - b over every leaf, max |a - b|)."""
    sq = sum(float((x.double() - y.double()).square().sum())
             for x, y in zip(a, b))
    mx = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    return sq ** 0.5, mx


def _train_launches(cfg) -> tuple:
    """(K2 forward, K2 backward, K3, K4, K4 backward, K3 backward) launches
    of one training step with remat full: each forward's K2, K3 and K4
    launches twice (the recompute), K2's dx once for every adapted
    projection but the first layer's (its input, the frozen embedding,
    carries no gradient: q and v of a dense layer, wx of a Mamba2 one), K3's
    backward once an attention layer (or shared-block application), K4's
    backward once a Mamba2 layer."""
    k2, k3, k4 = _launches_per_forward(cfg)
    first = 1 if cfg.arch_type in ("ssm", "hybrid") else len(cfg.lora.targets)
    return 2 * k2, k2 - first, 2 * k3, 2 * k4, k4, k3


def _count_plain_attention(k3):
    """Counts (``.n``) every call of ``flash_attention_ref`` made through
    K3's module from here on: its CPU routes, which the card's route must
    never reach. Restore ``k3.flash_attention_ref = calls.plain`` after
    the run."""
    plain = k3.flash_attention_ref

    def calls(*a, **kw):
        calls.n += 1
        return plain(*a, **kw)

    calls.n, calls.plain = 0, plain
    k3.flash_attention_ref = calls
    return calls


def _train_batches(torch, cfg, gen, dev, batch: int, seq: int, n: int):
    """``n`` training batches of ``batch`` x ``seq`` on the card: a token
    model's ShardedLMLoader tokens (seed SEED); an encoder's
    ``frontends.make_masked_prediction_batch`` (frame embeddings, codebook
    targets, the loss mask), drawn from ``gen``; the VLM's embeddings
    (``make_frontend_embeddings``) and random targets drawn from ``gen``,
    with the M-RoPE positions of VLM_RUN's image span."""
    from repro_torch.data import ShardedLMLoader
    from repro_torch.models.frontends import (make_frontend_embeddings,
                                              make_masked_prediction_batch,
                                              make_mrope_positions)
    from repro_torch.train.step import batch_to

    if not cfg.embed_inputs:
        loader = ShardedLMLoader(cfg.vocab_size, batch, seq, seed=SEED)
        return [batch_to(loader.batch_at(i), dev) for i in range(n)]
    if cfg.encoder_only:
        return [make_masked_prediction_batch(gen, cfg, batch, seq)
                for _ in range(n)]
    pos = torch.from_numpy(make_mrope_positions(batch, seq, VLM_RUN[3]))
    return [{"embeds": make_frontend_embeddings(gen, cfg, batch, seq),
             "targets": torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen, device=dev,
                                      dtype=torch.int32),
             "positions": pos.to(dev)} for _ in range(n)]


def _cut_grad_gate(torch, tag, cfg, grad, params, batch0, layers) -> None:
    """Step 0's LoRA gradients held at ``layers`` layers of full width (the
    deeper layers freed) where the f32 copy does not fit at the run's depth
    (Mixtral-8x7B at 16 layers would be 94 GB in f32): the bf16 kernel run
    must lie within twice the bf16 plain run's distance from the f32 plain
    run. For MoE a gradient sums over every token of the batch, and a
    routing swap (a token's experts differ between two runs:
    ROUTE_SWAP_MARGIN's ties) gives it another function, not a rounding of
    the same one; so the three runs take one routing: the f32 plain run
    routes freely, and the bf16 kernel and plain runs replay its experts
    call by call, their router weights and aux loss from their own gates
    (``_Routes(replay=)``). Every forward then agrees in all runs; the swaps
    each run's own router would have made are counted and printed."""
    import dataclasses

    from repro_torch.models import moe as moe_lib

    moe = cfg.moe is not None
    del params["layers"][layers:]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cut = dataclasses.replace(cfg, num_layers=layers)
    p32 = _widen(params)
    with _Routes(torch, moe_lib) as r32:
        _, g_32 = grad(dataclasses.replace(cut, dtype="float32"), p32, False)
    del p32
    torch.cuda.empty_cache()
    runs = {}
    for name, use_cuda in (("bf16 kernel", True), ("bf16 plain", False)):
        with _Routes(torch, moe_lib, replay=r32.idx) as routes:
            runs[name] = (grad(cut, params, use_cuda)[1], routes)
    if moe:
        seq = batch0["tokens"].shape[1]
        for what, a, b in (("bf16 kernel / f32 plain",
                            runs["bf16 kernel"][1], r32),
                           ("bf16 plain / f32 plain", runs["bf16 plain"][1],
                            r32),
                           ("bf16 kernel / bf16 plain",
                            runs["bf16 kernel"][1], runs["bf16 plain"][1])):
            sw = _route_swaps(torch, cut, a.calls[:layers],
                              b.calls[:layers], seq)
            _print_swaps(tag, f"{layers} layers, free routing of the "
                         f"{what} runs (replayed: not taken)", sw)
    g_k, g_p = runs["bf16 kernel"][0], runs["bf16 plain"][0]
    d_kp, mx_kp = _grad_distance(torch, g_k, g_p)
    d_p32, mx_p32 = _grad_distance(torch, g_p, g_32)
    d_k32, _ = _grad_distance(torch, g_k, g_32)
    routing = (", one routing (the f32 plain run's) in all three runs"
               if moe else "")
    print(f"[{tag}] {cfg.name} {layers} layers{routing}: |kernel - plain| "
          f"{d_kp:.4e} (L2 over the {len(g_k)} LoRA leaves; max "
          f"{mx_kp:.3e}) against twice the bf16 plain run's distance from "
          f"the f32 plain run {2 * d_p32:.4e} (max {mx_p32:.3e}); the kernel "
          f"run's own distance from f32 {d_k32:.4e}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not d_kp <= 2 * d_p32:
        _fail(f"[{tag}] {cfg.name} {layers} layers LoRA gradients: kernel "
              f"run {d_kp} from the plain run, bound {2 * d_p32}")


def _phase_train(torch, np, dev, kernels, tag="train", run=TRAIN_RUN,
                 steps=TRAIN_STEPS, layers=None, f32_layers=None) -> dict:
    """[train] / [train-ssm] / [train-vlm] / [train-audio] / [train-moe]:
    ``run`` = (arch, seq, batch) at full width (and depth, unless
    ``layers`` cuts it), bf16, LoRA fine-tuning through make_train_step
    with remat="full" on ``_train_batches``' batches. Step 0's LoRA
    gradients: finite and non-zero (the detach the autograd Functions
    close), and within twice the bf16 plain run's distance from an f32
    plain run (``KernelConfig(False)``: the plain attention,
    ``ssd_chunked``); where the f32 copy does not fit (``f32_layers`` given;
    MoE always) the distance (and the routing swaps) at the run's depth are
    printed, and the gate is ``_cut_grad_gate``'s at ``f32_layers`` layers,
    after the timed steps, on step 0's LoRA leaves (kept aside) and batch.
    Then
    TRAIN_WARMUP + ``steps`` steps timed, launch counts
    (``_train_launches``; under M-RoPE every K3 launch with positions), no
    plain attention on the card's route (``flash_attention_ref`` counted
    inside K3's module), peak memory, one traced step (the K3 and K4
    backward ranges holding their kernels' launches alone, 3 a launch each:
    no plain attention ops, no step-by-step loop; for MoE the layer's four
    ranges as parts of the busy split); the base weights bit-unchanged.
    Returns the timed steps' launches (``_train_counts``), the median step
    time, the trace's shares and the peak memory."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import (init_opt_state, make_grad_step,
                                        make_train_step)
    from repro_torch.utils.partition import (is_lora_path, partition_by_path,
                                             select_paths)

    k2, k3, k4 = kernels
    arch, seq, batch = run
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    moe = cfg.moe is not None
    cut = f32_layers is not None
    if moe and not cut:
        _fail(f"[{tag}] an MoE run's gradients are held at f32_layers")
    params, gen, init_s = _draw_model(torch, tf, cfg, dev)
    tcfg = TrainConfig(seq_len=seq, global_batch=batch, remat="full")
    t0 = time.perf_counter()
    batches = _train_batches(torch, cfg, gen, dev, batch, seq,
                             TRAIN_WARMUP + steps + 1)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    base = partition_by_path(params, lambda p: not is_lora_path(p))[0]
    t0 = time.perf_counter()
    base_bits = _bits_digest(torch, base)
    torch.cuda.synchronize()
    digest_s = time.perf_counter() - t0

    def grad(c, p, use_cuda):
        return make_grad_step(c, tcfg, KernelConfig(use_cuda))(p, batches[0])

    # step 0's gradients: kernel run, plain run, f32 plain run
    paths = [p for p, _ in select_paths(params, is_lora_path)]
    with _Routes(torch, moe_lib) as r_k:
        loss0, g_k = grad(cfg, params, True)
    torch.cuda.synchronize()
    for path, g in zip(paths, g_k):
        if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            _fail(f"[{tag}] {arch} step 0: the gradient of {path} is not "
                  "finite or is zero")
    with _Routes(torch, moe_lib) as r_p:
        _, g_p = grad(cfg, params, False)
    d_kp, mx_kp = _grad_distance(torch, g_k, g_p)
    if moe:
        # the routing of the two runs' first forwards (the remat
        # recompute repeats it)
        n = cfg.num_layers
        sw = _route_swaps(torch, cfg, r_k.calls[:n], r_p.calls[:n], seq)
        _print_swaps(tag, f"step 0, bf16, {n} layers", sw)
        if sw["first_gap"][0] > ROUTE_SWAP_MARGIN:
            _fail(f"[{tag}] a first-layer routing swap where the plain "
                  f"run's 2nd and 3rd router logits were "
                  f"{sw['first_gap'][0]} apart (> {ROUTE_SWAP_MARGIN})")
        print(f"[{tag}] {arch} step 0, {n} layers: loss "
              f"{float(loss0):.4f}; all {len(g_k)} LoRA gradients finite "
              f"and non-zero; |kernel - plain| {d_kp:.4e} (L2 over the "
              f"leaves; max {mx_kp:.3e}), {sum(sw['swaps'])} routing swaps "
              f"over {n} layers x {batch * seq} tokens (reported: the "
              f"random init amplifies a swap layer by layer; held at "
              f"{f32_layers} layers on step 0's leaves after the timed "
              "steps)")
    elif cut:
        print(f"[{tag}] {arch} step 0, {cfg.num_layers} layers: loss "
              f"{float(loss0):.4f}; all {len(g_k)} LoRA gradients finite "
              f"and non-zero; |kernel - plain| {d_kp:.4e} (L2 over the "
              f"leaves; max {mx_kp:.3e}) (reported: the f32 copy does not "
              f"fit beside the bf16 weights; held at {f32_layers} layers "
              "on step 0's leaves after the timed steps)")
    else:
        p32 = _widen(params)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        torch.cuda.empty_cache()
        _, g_32 = grad(cfg32, p32, False)
        del p32
        torch.cuda.empty_cache()
        d_p32, mx_p32 = _grad_distance(torch, g_p, g_32)
        d_k32, _ = _grad_distance(torch, g_k, g_32)
        print(f"[{tag}] {arch} step 0: loss {float(loss0):.4f}; all "
              f"{len(g_k)} LoRA gradients finite and non-zero; |kernel - "
              f"plain| {d_kp:.4e} (L2 over the leaves; max {mx_kp:.3e}) "
              f"against twice the bf16 plain run's distance from the f32 "
              f"plain run {2 * d_p32:.4e} (max {mx_p32:.3e}); the kernel "
              f"run's own distance from f32 {d_k32:.4e}")
        if not d_kp <= 2 * d_p32:
            _fail(f"[{tag}] {arch} step 0 LoRA gradients: kernel run "
                  f"{d_kp} from the plain run, bound {2 * d_p32}")
        del g_32
    del g_k, g_p, r_k, r_p
    torch.cuda.empty_cache()
    # a cut gate runs after the timed steps, on step 0's LoRA leaves
    lora0 = ([x.clone() for x in partition_by_path(params, is_lora_path)[0]]
             if cut else None)

    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg, KernelConfig(True))
    losses = []
    for i in range(TRAIN_WARMUP):
        params, opt, m = step(params, opt, batches[i])
        losses.append(float(m.loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(k2, k3, k4)
    times = []
    plain_calls = _count_plain_attention(k3)
    try:
        for i in range(TRAIN_WARMUP, TRAIN_WARMUP + steps):
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batches[i])
            losses.append(float(m.loss))      # waits for the step
            times.append(time.perf_counter() - t0)
    finally:
        k3.flash_attention_ref = plain_calls.plain
    if plain_calls.n:
        _fail(f"[{tag}] {arch}: the plain attention ran {plain_calls.n} "
              "times on the card's route")
    launches = _train_counts(k2, k3, k4)
    with_pos = k3.flash_attention.position_launches
    peak = torch.cuda.max_memory_allocated()
    n = cfg.num_layers
    per = _train_launches(cfg)
    if launches != tuple(steps * x for x in per):
        _fail(f"[{tag}] {arch} launches K2 forward / backward, K3, K4, K4 "
              f"backward, K3 backward {launches}, expected "
              f"{tuple(steps * x for x in per)}")
    if with_pos != (launches[2] if cfg.m_rope else 0):
        _fail(f"[{tag}] {arch}: {with_pos} of {launches[2]} K3 launches "
              "with positions")
    if not all(np.isfinite(losses)):
        _fail(f"[{tag}] {arch} non-finite loss: {losses}")
    tokens = batch * seq
    med = statistics.median(times)
    targets = ("wx, out_proj" + (f" and the shared block's "
                                 f"{', '.join(cfg.lora.targets)}"
                                 if cfg.arch_type == "hybrid" else "")
               if cfg.ssm is not None else ", ".join(cfg.lora.targets))
    depth = f"{n} layers" + ("" if layers is None
                             else f" of {get_config(arch).num_layers}")
    print(f"[{tag}] {cfg.name} ({depth}, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.2f} G parameters, bf16, LoRA r "
          f"{cfg.lora.rank} on {targets}: "
          f"{cfg.lora_param_count() / 1e6:.2f} M trained) drawn on the card "
          f"in {init_s:.2f} s; {batch} x {seq} "
          f"{'embeddings' if cfg.embed_inputs else 'tokens'} a step, remat "
          f"full, batches made in {data_s:.2f} s (before timing); "
          f"{steps} timed steps after {TRAIN_WARMUP} warm-up: "
          f"{', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s, "
          f"{tokens / med:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB; "
          f"launches a step K2 forward {launches[0] // steps}, K2 "
          f"backward {launches[1] // steps} (layer 0's input carries "
          f"no gradient), K3 {launches[2] // steps}"
          + (f" (all with positions)" if with_pos else "")
          + f", K3 backward {launches[5] // steps}, K4 "
          f"{launches[3] // steps}, K4 backward {launches[4] // steps}; no "
          f"plain attention; losses {', '.join(f'{x:.4f}' for x in losses)}")
    ranges = {k2.BACKWARD_DX: "K2 backward (dx)", k2.W_TRANSPOSE: "W^T copy",
              k2.BACKWARD_RANK_R: "dA / dB products",
              k3.BACKWARD: "K3 backward", k4.BACKWARD: "K4 backward"}
    if moe:
        # the MoE layer's forward and recompute; its backward's kernels
        # count by name (cuBLAS, elementwise, other)
        ranges.update({r: r for r in (moe_lib.ROUTE, moe_lib.DISPATCH,
                                      moe_lib.EXPERTS, moe_lib.COMBINE)})
    shares = _trace_call(torch, f"{cfg.name} train step",
                         lambda: step(params, opt, batches[-1]), ranges)
    if per[4] and shares is not None:
        # the backward's range holds its three bf16 kernels a launch (the
        # two state scans, the chunks' gradients, the finishing sums) and
        # nothing else: no step-by-step plain loop, no plain K4 op
        inside = shares["kernels_in"]["K4 backward"]
        if inside != 3 * per[4]:
            _fail(f"[{tag}] {arch} traced step: {inside} device kernels "
                  f"inside '{k4.BACKWARD}' over {per[4]} launches")
        print(f"[{tag}] {arch} traced step: {inside} device kernels inside "
              f"'{k4.BACKWARD}' over {per[4]} launches of K4's backward "
              "(3 a launch: states, gradients, finishing sums)")
    if per[5] and shares is not None:
        # K3's backward range holds its three kernels a launch (rowsum(P o
        # dP), dK / dV, dQ) and nothing else: no plain attention op
        inside = shares["kernels_in"]["K3 backward"]
        if inside != 3 * per[5]:
            _fail(f"[{tag}] {arch} traced step: {inside} device kernels "
                  f"inside '{k3.BACKWARD}' over {per[5]} launches, expected "
                  f"{3 * per[5]} (no plain attention ops)")
        print(f"[{tag}] {arch} traced step: {inside} device kernels inside "
              f"'{k3.BACKWARD}' over {per[5]} launches of K3's backward, "
              f"{shares['K3 backward']:.1f} ms (no plain attention ops)")
    base = partition_by_path(params, lambda p: not is_lora_path(p))[0]
    if any(not torch.equal(a, b) or x.grad is not None or x.requires_grad
           for x, a, b in zip(base, base_bits, _bits_digest(torch, base))):
        _fail(f"[{tag}] {arch} a base weight changed, holds a .grad or "
              "requires grad")
    print(f"[{tag}] {arch} the base weights are bit-unchanged (every "
          f"tensor's bits digested on the card before step 0, in "
          f"{digest_s:.2f} s, and after the steps: ``_bits_digest``) and "
          "hold no .grad")
    del base, base_bits, opt, step
    if cut:
        params = partition_by_path(params, is_lora_path)[1](lora0)
        _cut_grad_gate(torch, tag, cfg, grad, params, batches[0],
                       f32_layers)
    return {"launches": launches, "step_s": med, "shares": shares,
            "peak": peak, "steps": steps, "cfg": cfg, "seq": seq,
            "batch": batch}


def _load_example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phase_elastic(torch, dev, kernels, k1) -> tuple:
    """[elastic]: examples/elastic_finetune_torch.py's full setting on the
    card, against ELASTIC_REF's plan exactly; wall time, optimizer steps/s,
    first and last loss, and each checkpoint round trip's bytes and save /
    restore ms. Returns (K1, K2 forward, K2 backward, K3, K3 backward)
    launches."""
    import tempfile

    import numpy as np

    from repro_torch.train import elastic

    k2, k3, k4 = kernels
    ex = _load_example("elastic_finetune_torch")
    timed = {"save": [], "restore": []}

    def timing(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    saved = (elastic.save, elastic.restore)
    with tempfile.TemporaryDirectory() as d:
        trainer = ex.build(False, dev, d)
        # K2's shapes on this path ([k2-grad] holds them against the plain
        # version): q and v at (batch x seq, d) -> heads x head_dim
        cfg, tcfg = trainer.cfg, trainer.tcfg
        for n in {cfg.num_heads * cfg.head_dim,
                  cfg.num_kv_heads * cfg.head_dim}:
            shape = (tcfg.global_batch * tcfg.seq_len, cfg.d_model, n,
                     cfg.lora.rank)
            if shape not in K2_GRAD_SHAPES:
                _fail(f"[elastic] K2 runs at {shape}, not in K2_GRAD_SHAPES")
        elastic.save = timing("save", elastic.save)
        elastic.restore = timing("restore", elastic.restore)
        try:
            _reset_counts(k2, k3, k4)
            k1.window_dp.launches = k1.window_dp_rows.launches = 0
            k2.lora_matmul.backward_launches = 0
            t0 = time.perf_counter()
            rep = trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            elastic.save, elastic.restore = saved
    launches = (k1.window_dp.launches, k2.lora_matmul.launches,
                k2.lora_matmul.backward_launches, k3.flash_attention.launches,
                k3.flash_attention_backward.launches)
    got = {"slots": tuple((s.t, s.n_od, s.n_spot, s.mu, s.steps)
                          for s in rep.slots),
           "total_steps": rep.total_steps, "utility": rep.utility,
           "cost": rep.cost, "completion_time": rep.completion_time}
    if got != ELASTIC_REF:
        _fail(f"[elastic] plan {got} differs from JAX's {ELASTIC_REF}")
    if not all(launches):
        _fail(f"[elastic] K1, K2 forward, K2 backward, K3, K3 backward "
              f"launches {launches}: each must run")
    if not all(np.isfinite(rep.losses)):
        _fail("[elastic] non-finite loss")
    pol = ex.POLICY
    ckpts = [s.ckpt_bytes for s in rep.slots if s.ckpt_bytes]
    print(f"[elastic] {cfg.name} ({cfg.param_count() / 1e6:.0f} M "
          f"parameters, LoRA {cfg.lora_param_count() / 1e6:.2f} M) seq "
          f"{tcfg.seq_len}, batch {tcfg.global_batch}, AHAP({pol.omega}, "
          f"{pol.v}, {pol.sigma}) + ARIMA: plan, total_steps "
          f"{rep.total_steps}, utility {rep.utility:.6f}, cost "
          f"{rep.cost:.6f}, completion {rep.completion_time:.6f} equal "
          f"JAX's; wall {wall:.2f} s, {rep.total_steps / wall:.1f} optimizer "
          f"steps/s; loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}; "
          f"{len(ckpts)} checkpoint round trips of {ckpts} bytes, save "
          f"{', '.join(f'{x:.1f}' for x in timed['save'])} ms, restore "
          f"{', '.join(f'{x:.1f}' for x in timed['restore'])} ms; launches "
          f"K1 {launches[0]} (the AHAP windows), K2 {launches[1]} forward + "
          f"{launches[2]} backward, K3 {launches[3]} forward + {launches[4]} "
          "backward")
    return launches


def _phase_time_k2_backward(torch, gen, k2, lora_matmul_ref, shape,
                            launches):
    """K2's backward dx at a training path's shape (M, K, N, r): dy (M, K)
    of a projection whose forward weight W is (N, K), bf16. K2 on (dy, W^T,
    B^T, A^T), the plain version, ``torch.addmm(dy @ W^T, dy @ B^T, A^T)``
    (W^T read in place by cuBLAS) and the W^T copy, each by ``_graph_ms``.
    The bound is the forward's reckoning at the same (M, K, N, r)."""
    m, k, n, r = shape
    dy, wt, bt, at = _lora_case(torch, gen, m, k, n, r, torch.bfloat16)
    w, b, a = (t.t().contiguous() for t in (wt, bt, at))  # the forward's
    ms = _graph_ms(torch, lambda: k2._run(dy, wt, bt, at, 2.0))
    plain = _graph_ms(torch, lambda: lora_matmul_ref(dy, wt, bt, at, 2.0))
    lib = _graph_ms(torch, lambda: torch.addmm(dy @ w.t(), dy @ b.t(),
                                               a.t(), alpha=2.0))
    copy = _graph_ms(torch, lambda: w.t().contiguous())
    n_bytes = 2 * (m * k + k * n + k * r + r * n + m * n)
    n_ops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
    bound, b_ms, o_ms = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    return {"M": m, "K": k, "N": n, "r": r, "launches": launches, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "copy_ms": copy,
            "copy_bound_ms": 2 * 2 * k * n / HBM_BYTES_PER_S * 1e3,
            "bound_ms": bound, "bound_by": _bound_by(b_ms, o_ms)}


def _phase_seed(torch, fast_sim, window_opt, k1, pool, inp):
    """[seed]: the seed path (every lane runs all six rules, the window
    solve included, and selects by kind) at one Fig. 9 setting on the card:
    10 forecast-entry K1 launches, each over all N_JOBS x P rows, and every
    leaf bit-equal to the partitioned simulate_pool_jobs. Returns the
    launches."""
    from repro_torch.workload import PAPER_TPUT

    jobs, prices, avail, preds = inp
    n_rows = N_JOBS * len(pool["kind"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = fast_sim.simulate_pool_jobs(pool, jobs, PAPER_TPUT, prices, avail,
                                       preds)
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    rows = []
    solve = window_opt._solve_rows

    def record(job, tput, z0, *rest):
        rows.append(int(z0.shape[0]))
        return solve(job, tput, z0, *rest)

    before = _k1_counts(k1)
    window_opt._solve_rows = record
    try:
        t0 = time.perf_counter()
        mono = fast_sim.simulate_pool_jobs_monolithic(
            pool, jobs, PAPER_TPUT, prices, avail, preds)
        torch.cuda.synchronize()
        mono_s = time.perf_counter() - t0
    finally:
        window_opt._solve_rows = solve
    n = tuple(a - b for a, b in zip(_k1_counts(k1), before))
    if n != (10, 10) or rows != [n_rows] * 10:
        _fail(f"[seed] K1 launched {n[0]} times, {n[1]} of them the forecast "
              f"entry, over {rows} rows; expected 10 forecast-entry launches "
              f"over {n_rows} rows each")
    if set(mono) != set(part):
        _fail(f"[seed] leaves {sorted(mono)} != {sorted(part)}")
    for key in part:
        if not torch.equal(mono[key], part[key]):
            _fail(f"[seed] {key} of the seed path differs from the "
                  "partitioned path; they must be bit-equal")
    print(f"[seed] {SETTINGS[0][0]} {SETTINGS[0][1]}: simulate_pool_jobs_"
          f"monolithic over {N_JOBS} jobs x {len(pool['kind'])} lanes, K1 at "
          f"B = {n_rows:,} a slot (10 launches), {mono_s:.4f} s; partitioned "
          f"simulate_pool_jobs (K1 at B = {N_JOBS * 105:,}) {part_s:.4f} s; "
          f"every leaf bit-equal")
    return n[1]


def _shard_inputs(np, engine, fig9_inputs):
    """[shard]'s inputs as one dict of arrays: the first Fig. 9 setting's,
    [region]'s workload through prep (numpy), [fleet]'s sampled
    admission."""
    from repro_torch import workload
    from repro_torch.core import fast_sim

    arrays = {}
    jobs, prices, avail, preds = fig9_inputs
    market, rjobs, t0s, seeds = _region_workload(np)
    rmkt = engine.prepare_noisy_inputs_regions(
        market, t0s, REGION_SLOTS, *REGION_NOISE, seeds)
    _, arrs124 = _pool124()
    _, fprices, favail, fpred, arrivals, _, rows, idx = _fleet_workload(
        np, engine, arrs124)
    fjobs = fast_sim.stack_jobs([workload.PAPER_JOB] * FLEET_JOBS)
    for prefix, js in (("jobs", jobs), ("rjobs", rjobs), ("fjobs", fjobs)):
        arrays.update({f"{prefix}.{f}": np.asarray(getattr(js, f))
                       for f in js._fields})
    arrays.update({f"frows.{k}": np.asarray(v) for k, v in rows.items()})
    arrays.update(prices=prices, avail=avail, preds=preds,
                  rprices=rmkt[0], ravail=rmkt[1], rpreds=rmkt[2],
                  delta_mig=np.asarray(market.delta_mig), fprices=fprices,
                  favail=favail, fpred=fpred, farrivals=arrivals, fidx=idx)
    return arrays


def _digests(arrays: dict) -> dict:
    """{name: dtype, shape and SHA-256 of the bytes} of host arrays or
    tensors: equal digests are equal bits."""
    import hashlib

    import numpy as np

    out = {}
    for k, v in arrays.items():
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else \
            np.asarray(v)
        out[k] = (f"{a.dtype}{list(a.shape)}:" + hashlib.sha256(
            np.ascontiguousarray(a).tobytes()).hexdigest())
    return out


def _selection_arrays(res) -> dict:
    """Everything a collect=True, return_utilities=True SelectionResult
    holds, flat."""
    out = {f"sim_out.{k}": v for k, v in res.sim_out.items()}
    out.update(utilities=res.utilities, max_weight=res.max_weight,
               regret=res.regret, mean_utility=res.mean_utility,
               entropy=res.entropy, top_policy=res.top_policy,
               weights=res.state.weights)
    return out


def _shard_cases(np, inp):
    """[shard]'s three cases on ``inp`` (the arrays of _shard_inputs): name
    -> (run(mesh) -> the arrays to hold bit for bit, K1 forecast-entry
    launches a rank makes, the meshes it skips). ``mesh=None`` is the
    unsharded run. Each run also holds its JAX constants."""
    from repro_torch.core import engine, fleet
    from repro_torch.core.fast_sim import JobArrays
    from repro_torch.core.policy_pool import (paper_pool, region_pool,
                                              specs_to_arrays)
    from repro_torch.obs import ledger
    from repro_torch.workload import PAPER_TPUT

    group = lambda p: {k[len(p) + 1:]: inp[k] for k in inp
                       if k.startswith(p + ".")}
    pool, rpool = specs_to_arrays(paper_pool()), specs_to_arrays(
        region_pool())
    jobs, rjobs, fjobs = (JobArrays(**group(p))
                          for p in ("jobs", "rjobs", "fjobs"))
    rows = group("frows")
    common = dict(return_utilities=True, collect=True)

    def fig9(mesh):
        res = engine.simulate_and_select(
            pool, jobs, PAPER_TPUT, inp["prices"], inp["avail"],
            inp["preds"], sharded=mesh is not None, mesh=mesh, **common)
        _check_result("[shard] Fig. 9", res, JAX_REF[SETTINGS[0]],
                      len(pool["kind"]))
        return _selection_arrays(res)

    def region(mesh):
        res = engine.simulate_and_select(
            rpool, rjobs, PAPER_TPUT, inp["rprices"], inp["ravail"],
            inp["rpreds"], delta_mig=int(inp["delta_mig"]),
            p_od=REGION_P_OD, job_chunk=REGION_CHUNK,
            sharded=mesh is not None, mesh=mesh, **common)
        recon = ledger.migration_reconciliation(res.sim_out)
        best, t_half, ratio, migs = JAX_REGION["p_od"]
        got = (res.best_policy(), res.iters_to_half(),
               recon["total_migrations"])
        if got != (best, t_half, migs):
            _fail(f"[shard] region p_od: (best, iters_to_half, migrations) "
                  f"{got} != JAX {(best, t_half, migs)}")
        if abs(res.regret_ratio() - ratio) > REGRET_RTOL * ratio:
            _fail(f"[shard] region p_od: regret_ratio {res.regret_ratio()} "
                  f"vs JAX {ratio}")
        return _selection_arrays(res)

    def fleet_run(mesh):
        args = (rows, fjobs, inp["farrivals"], PAPER_TPUT, inp["fprices"],
                inp["favail"], inp["fpred"])
        out = (fleet.simulate_fleet(*args, collect=True) if mesh is None
               else fleet.simulate_fleet_sharded(*args, mesh=mesh,
                                                 collect=True))
        _check_fleet("[shard] sampled admission",
                     _fleet_summary(np, inp["fidx"], out, 124),
                     JAX_FLEET["sampled"])
        return out

    return {"fig9": (fig9, 10, ()),
            "region": (region, REGION_LAUNCHES, ()),
            "fleet": (fleet_run, FLEET_SLOTS, ((1, 4),))}


def _shard_worker(rank: int, world: int, backend: str, shapes,
                  work: Path) -> int:
    """One rank of a [shard] world: start the process group, load the built
    kernels, run every case on each of the world's meshes, and write each
    run's digests, wall and K1 launches to ``work``."""
    import datetime
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import window_dp as k1
    from repro_torch.launch.mesh import make_pool_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f"file://{work / f'rendezvous_{world}'}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    try:
        k1.load_library()
        with np.load(work / "inputs.npz") as f:
            inp = {k: f[k] for k in f.files}
        cases = _shard_cases(np, inp)
        report = {}
        for i, shape in enumerate(shapes):
            mesh = make_pool_mesh(shape)
            if i == 0:          # first-call costs stay out of the walls
                cases["fig9"][0](mesh)
            for name, (run, _, skip) in cases.items():
                if shape in skip:
                    continue
                before = _k1_counts(k1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(mesh)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = [a - b for a, b in zip(_k1_counts(k1), before)]
                report[f"{name} {shape}"] = {
                    "digests": _digests(out), "wall": wall, "launches": n}
            if i == 0:          # the Fig. 9 run once more, traced
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    cases["fig9"][0](mesh)
                    torch.cuda.synchronize()
                    pwall = time.perf_counter() - t0
                events = _device_events(prof)
                report["trace"] = {
                    "shape": list(shape), "wall": pwall,
                    "busy_ms": sum(e.self_device_time_total
                                   for e in events) / 1e3,
                    "k1_ms": sum(e.self_device_time_total for e in events
                                 if "window_dp" in e.key) / 1e3,
                    "events": sum(e.count for e in events)}
        (work / f"world{world}_rank{rank}.json").write_text(
            json.dumps(report))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _phase_shard(torch, np, engine, k1, fig9_inputs):
    """[shard]: the sharded selection engines on one card. The unsharded
    runs here on the card give the digests; then each world of
    SHARD_WORLDS is spawned from this script, its ranks sharing the card,
    and every rank's every run must match them bit for bit, with its JAX
    constants held and its K1 launches as expected (each rank launches
    the forecast entry once a slot on its own rows). Prints each world's
    walls and launches; returns all ranks' forecast-entry launches."""
    import shutil

    work = ROOT / "build" / "shard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_start = time.perf_counter()
    inp = _shard_inputs(np, engine, fig9_inputs)
    np.savez(work / "inputs.npz", **inp)
    cases = _shard_cases(np, inp)
    cases["fig9"][0](None)                      # warm-up
    want, base_wall = {}, {}
    for name, (run, _, _) in cases.items():
        before = _k1_counts(k1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want[name] = _digests(run(None))
        torch.cuda.synchronize()
        base_wall[name] = time.perf_counter() - t0
        n = _k1_counts(k1)[1] - before[1]
        if n != cases[name][1]:
            _fail(f"[shard] unsharded {name}: {n} forecast-entry K1 "
                  f"launches, expected {cases[name][1]}")
    print(f"[shard] unsharded on the card (one process): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in base_wall.items())
          + f"; inputs and refs {time.perf_counter() - t_start:.1f} s")

    launches = 0
    for backend, world, shapes in SHARD_WORLDS:
        t0 = time.perf_counter()
        logs = [open(work / f"world{world}_rank{r}.log", "w")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--shard-rank",
             str(r), str(world), backend, json.dumps(shapes), str(work)],
            stdout=log, stderr=subprocess.STDOUT) for r, log in
            enumerate(logs)]
        try:
            deadline = time.perf_counter() + SHARD_TIMEOUT
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        world_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                tail = (work / f"world{world}_rank{r}.log").read_text()[-3000:]
                _fail(f"[shard] {backend} world {world} rank {r} exited "
                      f"{p.returncode}:\n{tail}")
        reports = [json.loads((work / f"world{world}_rank{r}.json")
                              .read_text()) for r in range(world)]
        for shape in shapes:
            parts = []
            for name, (_, expect, skip) in cases.items():
                if shape in skip:
                    continue
                key = f"{name} {tuple(shape)}"
                for r, rep in enumerate(reports):
                    got = rep[key]
                    if got["digests"] != want[name]:
                        bad = sorted(k for k in want[name] if
                                     got["digests"].get(k) != want[name][k])
                        _fail(f"[shard] {backend} world {world} mesh {shape} "
                              f"rank {r}: {name} differs from the unsharded "
                              f"run in {bad}; it must be bit-equal")
                    if got["launches"] != [expect, expect]:
                        _fail(f"[shard] {backend} world {world} mesh {shape} "
                              f"rank {r}: {name} K1 launches "
                              f"{got['launches']}, expected {expect} "
                              "forecast-entry launches")
                    launches += got["launches"][1]
                walls = [rep[key]["wall"] for rep in reports]
                parts.append(f"{name} {max(walls):.3f} s (ranks "
                             + " / ".join(f"{w:.3f}" for w in walls)
                             + f"; {expect} K1 launches a rank)")
            print(f"[shard] {backend} world {world} mesh {tuple(shape)}: "
                  + "; ".join(parts) + "; bit-equal to the unsharded runs "
                  "on every rank, JAX constants held")
        traces = [rep["trace"] for rep in reports]
        wall = max(t["wall"] for t in traces)
        busy = sum(t["busy_ms"] for t in traces)
        if busy == 0:
            print(f"[trace] shard {backend} world {world}: device time not "
                  "measured (the profiler recorded no device events)")
        else:
            print(f"[trace] shard {backend} world {world} mesh "
                  f"{tuple(traces[0]['shape'])}, the Fig. 9 run: profiled "
                  f"wall {wall:.4f} s (slowest rank); device busy summed "
                  f"over the ranks {busy:.2f} ms = {busy / (wall * 1e3):.1%}"
                  f" of the wall (idle {1 - busy / (wall * 1e3):.1%}); "
                  f"K1 {sum(t['k1_ms'] for t in traces):.3f} ms; "
                  f"{sum(t['events'] for t in traces)} device events")
        print(f"[shard] {backend} world {world}: {world_s:.1f} s with the "
              "ranks' start-up")
    print(f"[shard] phase {time.perf_counter() - t_start:.1f} s, "
          f"{launches} forecast-entry K1 launches over the worlds' ranks")
    return launches


def _entry(name, source, replaces, launches, err, row):
    """One kernel of the ``kernels`` JSON line."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def _phase_dryrun(card: str) -> None:
    """[dryrun]: ``python -m repro_torch.launch.dryrun`` on olmo-1b x
    train_4k at full size on (16, 16), in a subprocess. The record's
    counts are printed; a FAILED record, a non-zero exit or a missing
    count fails. Then the record is held against the JAX package's,
    ``JAX_DRYRUN``: dot FLOPs per device within ``DRYRUN_FLOPS_REL`` once
    layer 0's backward products that only the reference runs are added
    (:func:`layer0_grads`), bf16-equivalent collective bytes at most
    ``DRYRUN_COLLECTIVE_BOUND`` times the reference's; traffic is printed
    beside the reference's, not held. CPU work on fake tensors: the counts
    of a step, not a run."""
    out = ROOT / "build" / "dryrun"
    if out.exists():
        shutil.rmtree(out)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
             "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        _fail(f"[dryrun] no end within {DRYRUN_TIMEOUT} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        _fail(f"[dryrun] exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
    recs = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
    if len(recs) != 1:
        _fail(f"[dryrun] {len(recs)} records, expected 1")
    r = recs[0]
    if r["status"] != "ok":
        _fail(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"{r['status']} {r.get('error') or r.get('reason')}")
    if not (r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
            and r["collective_bytes"] > 0 and r["while_trips"]):
        _fail(f"[dryrun] a count is missing: {r}")
    mem = r["memory"]
    print(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']} "
          f"({r['devices']} ranks, plain kernels): per device "
          f"{r['flops_per_device']:.4e} FLOPs, "
          f"{r['bytes_per_device']:.4e} bytes, collectives "
          f"{r['collective_bytes']:.4e} bytes ("
          + ", ".join(f"{k} {v['count']:.0f}" for k, v in
                      r["collectives"].items() if v["count"])
          + f"), loops {r['while_trips']}, arguments "
          f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB, peak "
          f"{mem['peak_size_in_bytes'] / 2**30:.3f} GiB; counted in "
          f"{r['run_s']} s, {wall:.1f} s with the process")
    ref = JAX_DRYRUN
    if (r["arch"], r["shape"], r["mesh"]) != ref["combination"]:
        _fail(f"[dryrun] JAX_DRYRUN holds {ref['combination']}, not "
              f"{(r['arch'], r['shape'], r['mesh'])}")
    from repro_torch.configs import INPUT_SHAPES, get_config

    shape = INPUT_SHAPES[r["shape"]]
    data = model = 16  # the (16, 16) production mesh; one sequence a
    # microbatch on each data rank
    extra = layer0_grads(get_config(r["arch"]), shape.seq_len,
                         shape.global_batch // data, model)
    flops = r["flops_per_device"] + extra
    ratios = {
        "flops": flops / ref["flops_per_device"],
        "collectives": (r["collective_bytes_bf16eq"]
                        / ref["collective_bytes_bf16eq"]),
        "collectives_raw": r["collective_bytes"] / ref["collective_bytes"],
        "traffic": (r["bytes_per_device_bf16eq"]
                    / ref["bytes_per_device_bf16eq"]),
    }
    print(f"[dryrun] against the JAX package's partitioned program (CPU "
          f"counts; card {card}): dot FLOPs {r['flops_per_device']:.5e} + "
          f"layer 0's reference-only {extra:.4e} = {flops:.5e} against "
          f"{ref['flops_per_device']:.5e} ({ratios['flops']:.4f}x); "
          f"collectives bf16-eq. {r['collective_bytes_bf16eq']:.4e} against "
          f"{ref['collective_bytes_bf16eq']:.4e} "
          f"({ratios['collectives']:.3f}x; raw {r['collective_bytes']:.4e} "
          f"against {ref['collective_bytes']:.4e}, "
          f"{ratios['collectives_raw']:.3f}x, XLA's CPU HLO widens bf16); "
          f"traffic bf16-eq. {r['bytes_per_device_bf16eq']:.4e} against "
          f"{ref['bytes_per_device_bf16eq']:.4e} ({ratios['traffic']:.3f}x, "
          f"not held: unfused ops against XLA's fusions)")
    if abs(ratios["flops"] - 1) > DRYRUN_FLOPS_REL:
        _fail(f"[dryrun] dot FLOPs {ratios['flops']:.4f}x the reference's, "
              f"beyond {DRYRUN_FLOPS_REL:.0%}")
    if ratios["collectives"] > DRYRUN_COLLECTIVE_BOUND:
        _fail(f"[dryrun] collective bytes {ratios['collectives']:.3f}x the "
              f"reference's, above {DRYRUN_COLLECTIVE_BOUND}")


def _phase_roofline(torch, card: str, train: dict, train_ssm: dict,
                    train_fam: dict) -> None:
    """[roofline]: llama2-7b at full width and depth counted on one device
    as the card runs it (``launch.dryrun.count(kernels=True)``, mesh None,
    on meta tensors: each K2 / K3 / K3-backward launch one op, its inputs
    read and
    outputs written once, its own operations; the rest op by op) at the
    three steps [serve] and [train] timed: the prefill of 8 x 1024 (into
    a 1024-slot cache; [serve]'s has 2048, 4.3 GB more zeros), a
    decode step of batch 8 against [serve]'s 2048-slot cache, and the
    training step of 8 x 1024, remat full. Each beside its roofline bound
    (``launch.roofline``, the H100's peaks), its measured time from those
    phases (no second run), the step MFU and the counted peak memory
    against the phase's ``torch.cuda.max_memory_allocated``. The counted
    kernel launches must equal the main path's, and a measured time below
    the compute term fails: that term is a strict lower bound, so the
    count would be wrong. The memory term counts every op's operands at
    the HBM rate, which the L2 can beat where they fit: it is reported,
    not held. Then mamba2-370m's training step of [train-ssm] the same
    way (K2, K4 and K4's backward by their own traffic and operations),
    beside [train-ssm]'s median step, and the training steps of
    [train-vlm], [train-audio], [train-moe] (Mixtral at its MOE_LAYERS) and
    DENSE_RUNS' [train-<name>] (at their depths) beside theirs. The count takes its batch as the dry run does, on meta
    tensors: Qwen2-VL's positions there count from 0, so K3's and its
    backward's pairs are the causal ones, and the image span's extra pairs
    (its patches see each other) are printed apart, not in the bound."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16

    cfg = get_config(SERVE_ARCH)
    serve = STEP_RUNS["serve"]
    arch, seq, batch = TRAIN_RUN
    if arch != SERVE_ARCH:
        _fail(f"[roofline] [serve] runs {SERVE_ARCH}, [train] {arch}")
    k2_fwd, k3_fwd, _ = _launches_per_forward(cfg)
    per_step = tuple(x // TRAIN_STEPS for x in train["launches"])
    ssm_arch, ssm_seq, ssm_batch = TRAIN_SSM_RUNS[0]
    ssm = train_ssm[ssm_arch]
    ssm_launches = tuple(x // ssm["steps"] for x in ssm["launches"])
    ssm_cfg = get_config(ssm_arch)

    def kernels(counts):
        """A step's launches (``_train_counts``' order) by the counter's
        kernel names."""
        return {"lora_matmul": counts[0] + counts[1],
                "flash_attention": counts[2], "ssd_scan": counts[3],
                "ssd_scan_backward": counts[4],
                "flash_attention_backward": counts[5]}

    steps = (
        (cfg, "prefill", ShapeConfig("prefill", SERVE_PROMPT, SERVE_BATCH,
                                     "prefill"), serve["prefill_s"],
         "one timed prefill of [serve]'s teacher-forced kernel run",
         serve["peak"], kernels((k2_fwd, 0, k3_fwd, 0, 0, 0))),
        (cfg, "decode", ShapeConfig("decode", SERVE_MAX_LEN, SERVE_BATCH,
                                    "decode"), serve["decode_s"],
         f"the mean of [serve]'s {SERVE_NEW} teacher-forced decode steps",
         serve["peak"], kernels((k2_fwd, 0, 0, 0, 0, 0))),
        (cfg, "train", ShapeConfig("train", seq, batch, "train"),
         train["step_s"], f"the median of [train]'s {TRAIN_STEPS} timed "
         "steps", train["peak"], kernels(per_step)),
        (ssm_cfg, "train", ShapeConfig("train", ssm_seq, ssm_batch,
                                       "train"),
         ssm["step_s"], f"the median of [train-ssm]'s {ssm['steps']} timed "
         "steps", ssm["peak"], kernels(ssm_launches)),
    ) + tuple(
        (r["cfg"], "train", ShapeConfig("train", r["seq"], r["batch"],
                                        "train"),
         r["step_s"], f"the median of [{tag}]'s {r['steps']} timed steps",
         r["peak"], kernels(tuple(x // r["steps"] for x in r["launches"])))
        for tag, r in train_fam.items())
    print(f"[roofline] card {card}; bounds from PEAK_FLOPS_BF16 "
          f"{PEAK_FLOPS_BF16:.3e} FLOP/s and HBM_BW {roofline.HBM_BW:.3e} "
          "B/s (NVIDIA H100 SXM datasheet)")
    for cfg, name, shape, measured, origin, peak, want in steps:
        acc = dryrun.count(cfg, shape, None, microbatches=1, kernels=True)
        ks = acc["kernels"]
        got = {k: ks.get(k, {}).get("count", 0) for k in want}
        if got != want or set(ks) - set(want):
            _fail(f"[roofline] {cfg.name} {name}: counted launches "
                  f"{ {k: v['count'] for k, v in ks.items()} }, the main "
                  f"path's {want}")
        mf = roofline.model_flops_per_device(cfg, shape, 1)
        t = roofline.terms(acc["dot_flops"], acc["traffic_bytes"], 0.0)
        bound = t["bound_s"]
        mfu = mf / (measured * PEAK_FLOPS_BF16)
        print(f"[roofline] {cfg.name} {name} ({shape.global_batch} x "
              f"{shape.seq_len}): dot FLOPs {acc['dot_flops']:.4e}, model "
              f"FLOPs {mf:.4e} (ratio {mf / acc['dot_flops']:.3f}), bytes "
              f"{acc['traffic_bytes']:.4e} ("
              + ", ".join(f"{k} {v['count']} launches {v['bytes']:.4e} "
                          f"bytes {v['flops']:.4e} FLOPs"
                          for k, v in sorted(ks.items()))
              + f"); bound {bound * 1e3:.3f} ms by "
              f"{t['dominant']} (compute {t['compute_s'] * 1e3:.3f} ms, "
              f"memory {t['memory_s'] * 1e3:.3f} ms); measured "
              f"{measured * 1e3:.3f} ms ({origin}), measured / bound "
              f"{measured / bound:.3f}, MFU {mfu:.4f}; counted peak "
              f"{acc['memory']['peak_size_in_bytes'] / 2**30:.2f} GiB "
              f"against the phase's max_memory_allocated "
              f"{peak / 2**30:.2f} GiB; counted in {acc['run_s']:.1f} s")
        if cfg.m_rope:
            from repro_torch.launch.op_analysis import attention_pairs
            from repro_torch.models.frontends import make_mrope_positions
            s = shape.seq_len
            pos = make_mrope_positions(1, s, VLM_RUN[3])[0, :, 0]
            extra = int((pos[None, :] <= pos[:, None]).sum()) - \
                attention_pairs(s, s, True, None)
            # K3 twice (remat) at 4 D a pair, its backward at 10 D
            flops = ((2 * 4 + 10) * cfg.head_dim * shape.global_batch
                     * cfg.num_heads * cfg.num_layers * extra)
            print(f"[roofline] {cfg.name} {name}: the image span "
                  f"{VLM_RUN[3]} adds {extra:,} unmasked pairs a head to the "
                  f"causal ones counted, {flops:.4e} FLOPs of K3 and its "
                  f"backward ({flops / acc['dot_flops']:.2%} of the count) "
                  "not in the bound")
        if measured < t["compute_s"]:
            _fail(f"[roofline] {cfg.name} {name}: measured {measured} s "
                  f"below its compute term {t['compute_s']} s")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--shard-rank"]:
        rank, world, backend, shapes, work = sys.argv[2:7]
        return _shard_worker(int(rank), int(world), backend,
                             [tuple(s) for s in json.loads(shapes)],
                             Path(work))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import engine, fast_sim, window_opt
    from repro_torch.core.policy_pool import paper_pool, specs_to_arrays
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import lora_matmul as k2
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import window_dp as k1
    from repro_torch.configs.base import ThroughputConfig
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         lora_matmul_ref,
                                         ssd_scan_grouped_ref, ssd_scan_ref,
                                         window_dp_ref)
    from repro_torch.core.window_opt import window_dp_rows_ref
    from repro_torch import workload

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    window_dp = k1.window_dp
    t_main = time.perf_counter()

    # ---- phase 1: identity and build ----
    card = _card_line()
    print(f"[id] card: {card}")
    print(f"[id] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = kbuild.build_all([k1.SOURCE, k2.SOURCE, k3.SOURCE,
                              k3.BACKWARD_SOURCE, k4.SOURCE,
                              k4.BACKWARD_SOURCE])
    for mod in (k1, k2, k3, k4):
        mod.load_library()
    k3.load_backward_library()
    k4.load_backward_library()
    build_s = time.perf_counter() - t0
    print(f"[id] K1, K2, K3, K3's backward, K4 and K4's backward built in "
          f"parallel in {build_s:.2f} s")
    for source, (lib_path, log) in built.items():
        print(f"[id] {source} -> {lib_path.relative_to(ROOT)}")
        for line in log.strip().splitlines():
            print(f"[nvcc] {line}")
    for line in _k3_bwd_usage(built[k3.BACKWARD_SOURCE][1],
                              k3.load_backward_library()):
        print(f"[id] K3 backward (wgmma) {line}")
    for line in _k4_bwd_usage(built[k4.BACKWARD_SOURCE][1],
                              k4.load_backward_library()):
        print(f"[id] K4 backward (wgmma) {line}")

    # ---- phase 2: K1's two entries against their plain versions ----
    sass = _k1_sass(built[k1.SOURCE][0])
    for name, c in (sass or {}).items():
        entry = "forecast" if "RowArgs" in name else "table"
        print(f"[k1] SASS of the (6, 16) strip kernel, {entry} entry: "
              + ", ".join(f"{k} {v}" for k, v in c.items()))
    if sass is None:
        print("[k1] SASS not read (no cuobjdump)")
    max_err = 0.0
    for b, w1, tn in ((1, 6, 16), (8, 6, 16), (13, 3, 5), (40, 1, 4)):
        c, g = _tables(b, w1, tn, b * 131 + w1, torch, dev)
        max_err = max(max_err, _compare_k1(f"test shape {(b, w1, tn)}", c,
                                           g, torch, window_dp,
                                           window_dp_ref))
    for b, w1, tn in ((64, 6, 16), (5000, 6, 16), (64, 3, 5)):
        c, g = _tie_tables(b, w1, tn, b + w1, torch, dev)
        max_err = max(max_err, _compare_k1(
            f"integer ties, half the rows priced out {(b, w1, tn)}", c, g,
            torch, window_dp, window_dp_ref))
    big_c, big_g = _tables(B_MAIN, W1, TN, 2024, torch, dev)
    max_err = max(max_err, _compare_k1("random tables", big_c, big_g, torch,
                                       window_dp, window_dp_ref))
    # the table entry at every shape [oracle]'s python AHAP gives it: B = 1,
    # w1 = omega + 1 over the AHAP lanes of both pools, tn = n_max over the
    # job stream's range
    from repro_torch.core.policy_pool import KIND_AHAP, region_pool
    oracle_w1 = sorted({s.omega + 1 for s in paper_pool() + region_pool()
                        if s.kind == KIND_AHAP})
    oracle_tn = sorted(int(v) for v in
                       np.unique(_region_workload(np)[1].n_max))
    for w1 in oracle_w1:
        for tn in oracle_tn:
            for make, what in ((_tables, "random"), (_tie_tables, "ties")):
                c, g = make(1, w1, tn, 7 * w1 + tn, torch, dev)
                max_err = max(max_err, _compare_k1(
                    f"the python AHAP's shape (1, {w1}, {tn}), {what}", c, g,
                    torch, window_dp, window_dp_ref, quiet=True))
    print(f"[k1] python AHAP's shapes: B=1, w1 in {oracle_w1}, tn in "
          f"{oracle_tn}, random and tie tables: "
          f"{2 * len(oracle_w1) * len(oracle_tn)} cases bit-equal")
    # the table entry at [elastic]'s shape: the example's AHAP window
    # (w1 = omega + 1) over its job's instance counts (tn = n_max)
    ex = _load_example("elastic_finetune_torch")
    w1, tn = ex.POLICY.omega + 1, ex.setting(False)[2].n_max
    for make, what in ((_tables, "random"), (_tie_tables, "ties")):
        c, g = make(1, w1, tn, 11 * w1 + tn, torch, dev)
        max_err = max(max_err, _compare_k1(
            f"the elastic trainer's shape (1, {w1}, {tn}), {what}", c, g,
            torch, window_dp, window_dp_ref))
    odd_tput = ThroughputConfig(alpha=0.7, beta=0.3)
    for b, w1, tn in ((1, 6, 16), (8, 6, 16), (13, 3, 5), (40, 1, 4),
                      (300, 6, 7)):
        for tput in (workload.PAPER_TPUT, odd_tput):
            _compare_k1_rows(f"random rows {(b, w1, tn)} alpha {tput.alpha} "
                             f"beta {tput.beta}",
                             _forecast_rows(b, w1, tn, 31 * b + tn, torch,
                                            dev),
                             tput, tn, torch, k1, window_dp_rows_ref)
    big_rows = _forecast_rows(B_MAIN, W1, TN, 2025, torch, dev)
    _compare_k1_rows("random rows", big_rows, workload.PAPER_TPUT, TN,
                     torch, k1, window_dp_rows_ref)

    # ---- phase 3: the main path, four Fig. 9 settings on paper_pool ----
    pool = specs_to_arrays(paper_pool())
    n_pol = len(pool["kind"])
    inputs, prep_s = {}, {}
    for kind, level in SETTINGS:
        t0 = time.perf_counter()
        inputs[(kind, level)] = _engine_inputs(kind, level, engine,
                                               workload, np)
        prep_s[(kind, level)] = time.perf_counter() - t0
    # warm-up: first-call costs (allocator, cuBLAS) stay out of the timings
    w = inputs[SETTINGS[0]]
    engine.simulate_and_select(pool, *w[:1], workload.PAPER_TPUT, *w[1:])

    window_dp.launches = k1.window_dp_rows.launches = 0
    results, wall = {}, {}
    for setting in SETTINGS:
        before = (window_dp.launches, k1.window_dp_rows.launches)
        t0 = time.perf_counter()
        results[setting] = engine.simulate_and_select(
            pool, inputs[setting][0], workload.PAPER_TPUT,
            *inputs[setting][1:], return_utilities=True)
        wall[setting] = time.perf_counter() - t0
        n = (window_dp.launches - before[0],
             k1.window_dp_rows.launches - before[1])
        if n != (10, 10):
            _fail(f"{setting}: K1 launched {n[0]} times, {n[1]} of them the "
                  "forecast entry; expected 10 forecast-entry launches "
                  "(one per market slot)")
    main_launches = window_dp.launches
    rows_launches = k1.window_dp_rows.launches
    print(f"[main] K1 launches over the four settings: {main_launches}, "
          f"{rows_launches} of them the forecast entry")

    # the same runs on the plain chain on the card; capture every slot's
    # rows of the first setting on the way
    captured = []
    plain_rows = window_opt._solve_rows

    def capture(job, tput, z0, std, prices, avail, tn, backend):
        if len(captured) < 10:
            captured.append((
                type(job)(**{f: getattr(job, f).clone()
                             for f in job.__dataclass_fields__}),
                z0.clone(), std.clone(), prices.clone(), avail.clone()))
        return plain_rows(job, tput, z0, std, prices, avail, tn, backend)

    torch_wall = {}
    window_opt._solve_rows = capture
    try:
        for setting in SETTINGS:
            t0 = time.perf_counter()
            plain = engine.simulate_and_select(
                pool, inputs[setting][0], workload.PAPER_TPUT,
                *inputs[setting][1:], backend="torch",
                return_utilities=True)
            torch_wall[setting] = time.perf_counter() - t0
            res = results[setting]
            if (plain.best_policy(), plain.iters_to_half()) != \
                    (res.best_policy(), res.iters_to_half()):
                _fail(f"{setting}: K1 run and plain-DP run disagree")
            if not np.array_equal(plain.utilities, res.utilities):
                diff = float(np.abs(plain.utilities - res.utilities).max())
                _fail(f"{setting}: utilities of the K1 and plain-DP runs "
                      f"differ (max {diff}); they must be bit-equal")
    finally:
        window_opt._solve_rows = plain_rows
    if len(captured) != 10:
        _fail(f"captured {len(captured)} slots of real rows, expected 10")
    for slot, rows in enumerate(captured):
        _compare_k1_rows(f"{SETTINGS[0][0]} {SETTINGS[0][1]} slot {slot} "
                         "real rows", rows, workload.PAPER_TPUT, TN, torch,
                         k1, window_dp_rows_ref)
    real_c, _, real_g = window_opt._unit_cost_table(
        captured[5][0], workload.PAPER_TPUT, *captured[5][1:],
        captured[5][0].on_demand_price, TN)
    max_err = max(max_err, _compare_k1("main-path slot 5 tables", real_c,
                                       real_g, torch, window_dp,
                                       window_dp_ref))

    for setting in SETTINGS:
        res = results[setting]
        _check_result(setting, res, JAX_REF[setting], n_pol)
        print(f"[main] {setting[0]} {setting[1]}: best={res.best_policy()} "
              f"iters_to_half={res.iters_to_half()} "
              f"regret_ratio={res.regret_ratio():.6f} "
              f"best_mean_u={res.mean_utility.max():.6f} "
              f"prep {prep_s[setting]:.3f} s engine {wall[setting]:.3f} s "
              f"({N_JOBS * n_pol / wall[setting]:.0f} cells/s) "
              f"plain-DP engine {torch_wall[setting]:.3f} s; matches JAX "
              "and the plain-DP run")

    # every cheap kind on the card: the 124-lane pool, one setting
    _, pool124 = _pool124()
    kinds = set(pool124["kind"].tolist())
    if kinds != {0, 1, 2, 3, 4, 5}:
        _fail(f"124-lane pool kinds {sorted(kinds)}")
    window_dp.launches = k1.window_dp_rows.launches = 0
    setting = SETTINGS[0]
    t0 = time.perf_counter()
    res124 = engine.simulate_and_select(
        pool124, inputs[setting][0], workload.PAPER_TPUT,
        *inputs[setting][1:], return_utilities=True)
    wall124 = time.perf_counter() - t0
    if (window_dp.launches, k1.window_dp_rows.launches) != (10, 10):
        _fail(f"124-lane run launched K1 {window_dp.launches} times, "
              f"{k1.window_dp_rows.launches} of them the forecast entry")
    _check_result("124-lane pool", res124, JAX_REF_124, len(pool124["kind"]))
    print(f"[main] 124-lane pool {setting}: best={res124.best_policy()} "
          f"iters_to_half={res124.iters_to_half()} engine {wall124:.3f} s; "
          "matches JAX")

    # stage split of one setting: simulate vs select, each synchronized
    jobs_d = fast_sim.jobs_to(inputs[setting][0], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fast_sim.simulate_pool_jobs(pool, jobs_d, workload.PAPER_TPUT,
                                      *inputs[setting][1:])
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    from repro_torch.core import selector
    t0 = time.perf_counter()
    st, _ = engine._normalize_and_scan(
        jobs_d, out["utility"], selector.eg_init(n_pol, N_JOBS), False)
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    print(f"[split] {setting}: simulate {sim_s:.4f} s, select (normalize + "
          f"EG over {N_JOBS} jobs) {sel_s:.4f} s")

    # ---- phase 4: K1's two entries beside their bound and plain versions
    clock = _max_sm_clock_mhz()
    k1_rows = _phase_time_k1(torch, k1, workload.PAPER_TPUT, window_dp_ref,
                             window_dp_rows_ref, big_c, big_g, big_rows,
                             captured, clock)
    for entry, row in k1_rows.items():
        real = ", ".join(f"{ms * 1e3:.1f}" for ms in row["real_ms"])
        print(f"[time] card {card}: K1 {entry} entry at B={B_MAIN} (w1, tn) "
              f"= ({W1}, {TN}): {row['ms'] * 1e3:.1f} us/launch in a CUDA "
              f"graph on random {'tables' if entry == 'table' else 'rows'}, "
              f"{row['event_ms'] * 1e3:.1f} us by "
              f"events (before the redesign, by events: "
              f"{K1_BEFORE_US} us); the 10 real slots' "
              f"{'tables' if entry == 'table' else 'rows'} in a graph: "
              f"{real} us; bound {row['bound_ms'] * 1e3:.1f} us by "
              f"{row['bound_by']} (bytes {row['bytes_ms'] * 1e3:.1f} us for "
              f"{row['bytes'] / 1e6:.2f} MB; {row['cand'] / 1e6:.1f} M "
              f"reachable candidates, {row['instr'] / 1e6:.1f} M FADD + "
              f"FMNMX at {F32_LANES_PER_SM} lanes x {H100_SMS} SMs x "
              f"{clock:.0f} MHz: {row['ops_ms'] * 1e3:.1f} us) = "
              f"{row['bound_ms'] / row['ms']:.1%} of bound; plain "
              f"{row['plain_ms'] * 1e3:.1f} us; library_ms null (no PyTorch "
              "call computes a min-plus DP)")
    print("[time] engine per setting: " + "; ".join(
        f"{k} {lv}: {wall[(k, lv)]:.3f} s, "
        f"{N_JOBS * n_pol / wall[(k, lv)]:.0f} cells/s"
        for k, lv in SETTINGS))
    _phase_trace_selection(torch, engine, fast_sim, window_opt, pool,
                           inputs[SETTINGS[0]], captured[5], dev)

    # ---- phase 4b: the chaos sweep and the scenario grid (124 lanes) ----
    chaos_launches, chaos_inp = _phase_chaos(np, engine, k1)
    grid_launches = _phase_grid(np, k1)
    print(f"[launches] K1 forecast entry per path: main {rows_launches}, "
          f"chaos {chaos_launches}, grid {grid_launches}")
    _phase_trace_chaos(torch, engine, chaos_inp)

    # ---- phase 4c: the regional selection path and the reference chain
    region_launches = _phase_region(torch, np, engine, fast_sim, k1)
    oracle_rows, oracle_table = _phase_oracle(torch, np, engine, fast_sim,
                                              k1, inputs[SETTINGS[0]])
    print(f"[launches] K1 forecast entry: region {region_launches}, oracle "
          f"{oracle_rows}; K1 table entry: oracle {oracle_table}")

    # ---- phase 4d: fleet contention (the pilot, admission, the engine,
    # the oracle) ----
    fleet_rows, fleet_table = _phase_fleet(torch, np, engine, fast_sim,
                                           window_opt, k1, window_dp_rows_ref)
    print(f"[launches] K1 forecast entry: fleet {fleet_rows}; K1 table "
          f"entry: fleet oracle {fleet_table}")
    for entry, row in _phase_time_k1_region(
            torch, k1, workload.PAPER_TPUT, window_dp_ref,
            window_dp_rows_ref, _max_sm_clock_mhz()).items():
        extra = (f"; one solve_window_numpy call (python AHAP, host wall) "
                 f"{row['call_ms']:.3f} ms" if entry == "table" else "")
        print(f"[time] card {card}: K1 {entry} entry at this slice's shape "
              f"B={row['B']} (w1, tn) = ({row['w1']}, {row['tn']}): "
              f"{row['ms'] * 1e3:.1f} us/launch in a CUDA graph; bound "
              f"{row['bound_ms'] * 1e6:.3f} ns by {row['bound_by']}; plain "
              f"{row['plain_ms'] * 1e3:.1f} us{extra}")

    # ---- phase 4e: the seed path and the sharded selection engines ----
    seed_launches = _phase_seed(torch, fast_sim, window_opt, k1, pool,
                                inputs[SETTINGS[0]])
    shard_launches = _phase_shard(torch, np, engine, k1,
                                  inputs[SETTINGS[0]])
    print(f"[launches] K1 forecast entry: seed {seed_launches}, shard "
          f"{shard_launches} (summed over the worlds' ranks)")

    # ---- phase 5: dense-model serving (K2, K3) ----
    kernels = (k2, k3, k4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k2_err = _phase_k2(torch, gen, k2, lora_matmul_ref)
    k3_err = _phase_k3(torch, gen, k3, flash_attention_ref)
    _phase_serve_ref(torch, np, dev, kernels)
    launches = {"serve": _phase_serve(torch, np, dev, kernels)}
    torch.cuda.empty_cache()

    # ---- phase 6: SSM and hybrid serving (K2, K3, K4) ----
    k4_err = _phase_k4(torch, gen, k4, ssd_scan_ref, ssd_scan_grouped_ref)
    for tag, (arch, seed, tokens) in FAMILY_REFS.items():
        _phase_serve_ref(torch, np, dev, kernels, tag, arch, seed, tokens)
    for tag, (arch, batch, prompt, new, max_len) in FAMILY_RUNS.items():
        launches[tag] = _phase_serve(torch, np, dev, kernels, tag, arch,
                                     batch, prompt, new, max_len)
        torch.cuda.empty_cache()

    # ---- phase 6b: MoE serving (K2 on q and v, K3 with a window) ----
    arch, seed, length, tokens = MOE_REF
    _phase_serve_ref(torch, np, dev, kernels, "serve-moe-ref", arch, seed,
                     tokens, length, MOE_REF_MAX_LEN)
    launches["serve-moe"] = _phase_serve(torch, np, dev, kernels,
                                         "serve-moe", *MOE_RUN,
                                         layers=MOE_LAYERS,
                                         f32_layers=MOE_F32_LAYERS)
    torch.cuda.empty_cache()

    # ---- phase 6c: VLM and audio (embeddings in; K3 with positions) ----
    k3_err = max(k3_err, _phase_k3_positions(torch, np, gen, k3,
                                             flash_attention_ref))
    _phase_vlm_ref(torch, np, dev, kernels)
    launches["vlm"] = _phase_vlm(torch, np, dev, kernels)
    torch.cuda.empty_cache()
    _phase_audio_ref(torch, np, dev, kernels)
    launches["audio"] = _phase_audio(torch, np, dev, kernels)
    torch.cuda.empty_cache()

    # ---- phase 6d: the last five architectures (MQA, q / k / v biases,
    # LayerNorm, tied heads, Mixtral-8x22B's MoE layer) ----
    for arch, (seed, length, max_len, tokens) in DENSE_REFS.items():
        _phase_serve_ref(torch, np, dev, kernels, "serve-dense-ref", arch,
                         seed, tokens, length, max_len)
    for name, (arch, layers, f32_layers, peak_gb) in DENSE_RUNS.items():
        tag, t0 = f"serve-{name}", time.perf_counter()
        launches[tag] = _phase_serve(torch, np, dev, kernels, tag, arch,
                                     layers=layers, f32_layers=f32_layers)
        torch.cuda.empty_cache()
        print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s; peak memory "
              f"of the engine's run {STEP_RUNS[tag]['peak'] / 1e9:.1f} GB "
              f"(predicted {peak_gb[0]:.0f} GB)")

    # ---- phase 6d: LoRA fine-tuning (K2 forward and backward, K3 and its
    # backward; K1 in the elastic trainer's AHAP decisions) ----
    t_train = time.perf_counter()
    k2_y_err, k2_dx_err = _phase_k2_grad(torch, gen, k2, lora_matmul_ref)
    k2_err = max(k2_err, k2_y_err)
    k3_y_err, k3_bwd_err = _phase_k3_grad(torch, gen, k3)
    k3_err = max(k3_err, k3_y_err)
    k4_y_err, k4_bwd_err = _phase_k4_grad(torch, gen, k4)
    k4_err = max(k4_err, k4_y_err)
    torch.cuda.empty_cache()
    _phase_train_ref(torch, dev, kernels)
    train = _phase_train(torch, np, dev, kernels)
    launches["train"] = train["launches"]
    torch.cuda.empty_cache()
    # ---- the SSM and hybrid families (K2, K3, K4 and their backwards) --
    for arch in TRAIN_SSM_ARCHS:
        _phase_train_ref(torch, dev, kernels, "train-ssm-ref", arch,
                         TRAIN_SSM_REF[arch])
    train_ssm = {}
    for run in TRAIN_SSM_RUNS:
        train_ssm[run[0]] = _phase_train(torch, np, dev, kernels,
                                         "train-ssm", run, TRAIN_SSM_STEPS)
        torch.cuda.empty_cache()
    # ---- the MoE, VLM and audio families (K2, K3 with a window, on the
    # position path, non-causal at D 80, and K3's backward) ----
    for arch in TRAIN_FAM_ARCHS:
        _phase_train_ref(torch, dev, kernels, "train-fam-ref", arch,
                         TRAIN_FAM_REF[arch])
    train_fam = {}
    for tag, (arch, seq, batch, layers) in TRAIN_FAM_RUNS.items():
        train_fam[tag] = _phase_train(
            torch, np, dev, kernels, tag, (arch, seq, batch),
            TRAIN_FAM_STEPS, layers,
            MOE_F32_LAYERS if tag == "train-moe" else None)
        torch.cuda.empty_cache()
    # ---- the last five architectures ----
    for arch in DENSE_REFS:
        _phase_train_ref(torch, dev, kernels, "train-dense-ref", arch,
                         TRAIN_DENSE_REF[arch])
    train_dense = {}
    for name, (arch, layers, f32_layers, peak_gb) in DENSE_RUNS.items():
        tag, t0 = f"train-{name}", time.perf_counter()
        train_dense[tag] = _phase_train(torch, np, dev, kernels, tag,
                                        (arch,) + TRAIN_RUN[1:],
                                        TRAIN_FAM_STEPS, layers, f32_layers)
        torch.cuda.empty_cache()
        print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s; peak memory "
              f"of the timed steps {train_dense[tag]['peak'] / 1e9:.1f} GB "
              f"(predicted {peak_gb[1]:.0f} GB)")
    elastic_launches = _phase_elastic(torch, dev, kernels, k1)
    print(f"[launches] K1 table entry: elastic {elastic_launches[0]}; "
          f"[train] K2 {launches['train'][0]} forward + "
          f"{launches['train'][1]} backward, K3 {launches['train'][2]} "
          f"forward + {launches['train'][5]} backward; "
          + "; ".join(f"[train-ssm] {arch} K2 {r['launches'][0]} forward + "
                      f"{r['launches'][1]} backward, K3 {r['launches'][2]} "
                      f"+ {r['launches'][5]} backward, "
                      f"K4 {r['launches'][3]} forward + {r['launches'][4]} "
                      "backward" for arch, r in train_ssm.items())
          + "".join(f"; [{tag}] K2 {r['launches'][0]} forward + "
                    f"{r['launches'][1]} backward, K3 {r['launches'][2]} + "
                    f"{r['launches'][5]} backward"
                    for tag, r in {**train_fam, **train_dense}.items())
          + f"; training phases {time.perf_counter() - t_train:.1f} s")

    # ---- phase 7: K2's, K3's and K4's time beside their bounds ----
    launches.update((tag, r["launches"])
                    for tag, r in {**train_fam, **train_dense}.items())
    k2_shapes = _k2_shapes(launches)
    k2_rows = dict(zip(k2_shapes, _phase_time_k2(
        torch, gen, k2, lora_matmul_ref, k2_shapes.values())))
    # [train]'s q / v forward (and remat recompute) and its K3 forward run
    # at the serving prefill's shapes: its rows are the prefill's
    if (TRAIN_RUN[0], TRAIN_RUN[1] * TRAIN_RUN[2]) != (
            SERVE_ARCH, SERVE_PROMPT * SERVE_BATCH):
        _fail(f"TRAIN_RUN {TRAIN_RUN} is not the serving prefill's shape")
    k2_rows["train"] = dict(k2_rows["prefill"], launches=launches["train"][0])
    for phase, row in k2_rows.items():
        cold = (f"cold, rotating through {row['footprint'] / 1e6:.1f} MB of "
                "inputs" if row["M"] <= 64 else "warm")
        print(f"[time] card {card}: K2 {phase} at (M, K, N, r) = "
              f"({row['M']}, {row['K']}, {row['N']}, {row['r']}) bf16 "
              f"({cold}): {row['ms'] * 1e3:.1f} us/launch "
              f"({row['launches']} launches on its serving or train path; "
              f"before the redesign {_before(phase)}); bound "
              f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} = "
              f"{row['bound_ms'] / row['ms']:.1%} "
              f"of bound; plain {row['plain_ms'] * 1e3:.1f} us; "
              f"torch.addmm(x @ W, x @ A, B) {row['library_ms'] * 1e3:.1f} us "
              f"(kernel / addmm {row['ms'] / row['library_ms']:.2f}x; no "
              "single PyTorch call computes it)")
    from repro_torch.configs import get_config
    zamba = get_config(FAMILY_RUNS["serve-hybrid"][0])
    k3_rows = {
        "flash_attention": _phase_time_k3(
            torch, gen, k3, flash_attention_ref, SERVE_BATCH, 32,
            SERVE_PROMPT, 128),
        "flash_attention/zamba2": _phase_time_k3(
            torch, gen, k3, flash_attention_ref, FAMILY_RUNS["serve-hybrid"][1],
            zamba.num_heads, FAMILY_RUNS["serve-hybrid"][2], zamba.head_dim),
        "flash_attention/mixtral": _phase_time_k3(
            torch, gen, k3, flash_attention_ref, MOE_RUN[1], 32, MOE_RUN[2],
            128, window=get_config(MOE_RUN[0]).sliding_window),
    }
    from repro_torch.models.frontends import make_mrope_positions
    vlm, hubert = get_config(VLM_RUN[0]), get_config(AUDIO_RUN[0])
    _, v_batch, v_prompt, v_span, _, _ = VLM_RUN
    vlm_pos = torch.from_numpy(np.ascontiguousarray(make_mrope_positions(
        1, v_prompt, v_span)[0, :, 0])).to(dev)
    k3_rows["flash_attention/qwen2-vl"] = _phase_time_k3(
        torch, gen, k3, flash_attention_ref, v_batch, vlm.num_heads,
        v_prompt, vlm.head_dim, q_pos=vlm_pos)
    k3_rows["flash_attention/hubert"] = _phase_time_k3(
        torch, gen, k3, flash_attention_ref, AUDIO_RUN[1], hubert.num_heads,
        AUDIO_RUN[2], hubert.head_dim, causal=False)
    k3_rows["flash_attention/qwen2-vl"]["launches"] = launches["vlm"][2]
    k3_rows["flash_attention/hubert"]["launches"] = launches["audio"][1]
    k3_rows["flash_attention"]["launches"] = launches["serve"][2]
    k3_rows["flash_attention/train"] = dict(k3_rows["flash_attention"],
                                            launches=launches["train"][2])
    k3_rows["flash_attention/mixtral"]["launches"] = launches["serve-moe"][2]
    k3_rows["flash_attention/zamba2"]["launches"] = \
        launches["serve-hybrid"][2]
    # DENSE_RUNS' prefills, and their training forwards (and remat
    # recomputes) at the same shapes
    for name, run in DENSE_RUNS.items():
        c = get_config(run[0])
        row = _phase_time_k3(torch, gen, k3, flash_attention_ref,
                             SERVE_BATCH, c.num_heads, SERVE_PROMPT,
                             c.head_dim, window=c.sliding_window)
        k3_rows[f"flash_attention/{name}"] = dict(
            row, launches=launches[f"serve-{name}"][2])
        k3_rows[f"flash_attention/{name}-train"] = dict(
            row, launches=launches[f"train-{name}"][2])
    for name, row in k3_rows.items():
        mask = ("causal by an image span's positions" if row.get("positions")
                else "causal" if row.get("causal", True) else "non-causal")
        sdpa = " with its boolean attn_mask" if row.get("positions") else ""
        print(f"[time] card {card}: K3 ({name}) at (BH, S, D) = "
              f"({row['BH']}, {row['S']}, {row['D']}) {mask} bf16: "
              f"{row['ms'] * 1e3:.1f} us/launch ({row['launches']} launches "
              f"on its serving or train path); bound "
              f"{row['bound_ms'] * 1e3:.1f} us by "
              f"{row['bound_by']} = {row['bound_ms'] / row['ms']:.1%} of "
              f"bound; before the redesign {_before(name)}; plain "
              f"{row['plain_ms'] * 1e3:.1f} us; "
              f"F.scaled_dot_product_attention{sdpa} "
              f"{row['library_ms'] * 1e3:.1f} us (kernel / SDPA "
              f"{row['ms'] / row['library_ms']:.2f}x)")
    k4_rows = {}
    for tag, layout in _ssd_layouts().items():
        name = "ssd_scan/" + FAMILY_RUNS[tag][0].split("-")[0]
        k4_rows[name] = _phase_time_k4(torch, gen, k4, ssd_scan_ref,
                                       ssd_scan_grouped_ref, *layout)
        k4_rows[name]["grouped"]["launches"] = launches[tag][3]
    for name, rows in k4_rows.items():
        for kind, row in rows.items():
            where = ("the model's layout, read in place: this is what its "
                     "serving path launches" if kind == "grouped" else
                     "flattened copies, B and C repeated to heads")
            print(f"[time] card {card}: K4 ({name}, {kind}) at (Bt, S, H, "
                  f"P, G, N) = ({row['Bt']}, {row['S']}, {row['H']}, "
                  f"{row['P']}, {row['G']}, {row['N']}) bf16, {where}: "
                  f"{row['ms'] * 1e3:.1f} us/launch in a CUDA graph, "
                  f"{row['event_ms'] * 1e3:.1f} us by events (before the "
                  f"redesign, flattened, by events: "
                  f"{BEFORE_US[name]:,.1f} us); bound "
                  f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
                  f"({row['bytes'] / 1e6:.1f} MB, {row['ops'] / 1e9:.1f} G "
                  f"operations) = {row['bound_ms'] / row['ms']:.1%} of bound; "
                  f"plain (step by step) {row['plain_ms'] * 1e3:.1f} us; no "
                  "library call (no PyTorch call computes the SSD scan)")
        g_row, f_row = rows["grouped"], rows["flattened"]
        print(f"[time] K4 ({name}): grouped / flattened "
              f"{g_row['ms'] / f_row['ms']:.3f} in a CUDA graph, "
              f"{g_row['event_ms'] / f_row['event_ms']:.3f} by events; "
              f"{rows['grouped']['launches']} launches on its serving path")

    k4_back = {}
    for arch, shape in _ssd_train_layouts().items():
        row = _phase_time_k4_backward(torch, gen, k4, *shape)
        row["launches"] = train_ssm[arch]["launches"][4]
        k4_back[arch] = row
        print(f"[time] card {card}: K4 backward ({arch}'s training shape) "
              f"at (Bt, S, H, P, G, N) = {shape} bf16, x / B / C views of "
              f"one buffer: {row['ms'] * 1e3:.1f} us/launch in a CUDA graph "
              f"(before the redesign, f32 CUDA cores: "
              f"{' / '.join(f'{v:,.1f}' for v in K4_BWD_BEFORE_US[arch])} "
              f"us), {row['event_ms'] * 1e3:.1f} us by events "
              f"({row['launches']} launches on [train-ssm]'s "
              f"{TRAIN_SSM_STEPS} timed steps); "
              f"bound {row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
              f"({row['bytes'] / 1e6:.1f} MB, {row['ops'] / 1e9:.1f} G "
              f"operations) = {row['bound_ms'] / row['ms']:.1%} of bound; "
              f"issued {row['issued_ops'] / 1e9:.1f} G operations (hi + lo "
              f"halves counted) at "
              f"{row['issued_ops'] / row['ms'] / 1e9:.1f} TFLOP/s = "
              f"{row['issued_ops'] * 1e3 / row['ms'] / BF16_OPS_PER_S:.1%} "
              f"of the bf16 peak; "
              f"plain (ssd_scan_grouped_bwd_ref) "
              f"{row['plain_ms'] * 1e3:.1f} us; autograd's backward through "
              f"models/ssm.ssd_chunked (the plain training run's, chunk "
              f"{row['chunk']}) {row['chunked_ms'] * 1e3:.1f} us; no "
              "library call (no PyTorch call computes the SSD scan's "
              "gradients)")

    k3_back = {}
    k3_back_runs = {"llama2": launches["train"][5],
                    "zamba2": train_ssm["zamba2-2.7b"]["launches"][5],
                    "qwen2-vl": train_fam["train-vlm"]["launches"][5],
                    "hubert": train_fam["train-audio"]["launches"][5],
                    "mixtral": train_fam["train-moe"]["launches"][5]}
    k3_back_runs.update((name, train_dense[f"train-{name}"]["launches"][5])
                        for name in DENSE_RUNS)
    k3_shapes = _k3_train_shapes()
    for name, shape in k3_shapes.items():
        row = _phase_time_k3_backward(torch, gen, k3, *shape)
        row["launches"] = k3_back_runs[name]
        k3_back[name] = row
        print(f"[time] card {card}: K3 backward ({name}'s training shape) "
              f"at (BH, S, D) = {shape[:3]} {_mask_label(shape[3])} bf16: "
              f"{row['ms'] * 1e3:.1f} us/launch in a CUDA graph, "
              f"{row['event_ms'] * 1e3:.1f} us by events "
              f"({row['launches']} launches on its training path's timed "
              f"steps); bound {row['bound_ms'] * 1e3:.1f} us by "
              f"{row['bound_by']} ({row['bytes'] / 1e6:.1f} MB, "
              f"{row['ops'] / 1e9:.2f} G operations over {row['pairs']:,} "
              f"pairs a head) = {row['bound_ms'] / row['ms']:.1%} of bound; "
              f"issued {row['issued_ops'] / 1e9:.1f} G operations (24 D a "
              f"pair{', every tile pair' if 'span' in shape[3] else ''}) "
              f"at {row['issued_ops'] / row['ms'] / 1e9:.1f} TFLOP/s "
              f"= {row['issued_ops'] * 1e3 / row['ms'] / BF16_OPS_PER_S:.1%} "
              f"of the bf16 peak; "
              f"plain (flash_attention_bwd_ref) {row['plain_ms'] * 1e3:.1f} "
              f"us; autograd through flash_attention_ref (the route before "
              f"the kernel) {row['autograd_plain_ms'] * 1e3:.1f} us; "
              f"F.scaled_dot_product_attention's backward"
              f"{' with its boolean attn_mask' if 'span' in shape[3] else ''}"
              f" {row['library_ms'] * 1e3:.1f} us (kernel / SDPA "
              f"{row['ms'] / row['library_ms']:.2f}x)")

    # each K1 entry with its own main-path launches (window_dp.launches
    # counts both): the forecast entry's in the Fig. 9 settings, the chaos
    # runs, the grid pass, the regional runs and the oracle's vectorized
    # lanes; the table entry's in the oracle's python AHAP decisions
    k1_entries = [
        _entry(f"window_dp/{entry}", "window_dp.cu",
               "src/repro/kernels/window_dp.py:36", own, max_err,
               k1_rows[entry])
        for entry, own in (
            ("forecast", rows_launches + chaos_launches + grid_launches
             + region_launches + oracle_rows + fleet_rows + seed_launches
             + shard_launches),
            ("table", main_launches - rows_launches + oracle_table
             + fleet_table))]
    # K2's backward dx on each training path: [train]'s (llama2-7b's q / v,
    # square), then each projection of [train-vlm], [train-audio] and
    # [train-moe], dy (M, N) against the forward's W (K, N)
    arch, seq, batch = TRAIN_RUN
    cfg = get_config(arch)
    k2_back = {"backward": _phase_time_k2_backward(
        torch, gen, k2, lora_matmul_ref,
        (batch * seq, cfg.num_heads * cfg.head_dim, cfg.d_model,
         cfg.lora.rank), launches["train"][1])}
    timed = {}
    for name, (m, k, n, tag, share) in _k2_train_rows().items():
        if (m, k, n) not in timed:
            timed[(m, k, n)] = _phase_time_k2_backward(
                torch, gen, k2, lora_matmul_ref, (m, n, k, 16), None)
        k2_back[f"backward/{name}"] = dict(
            timed[(m, k, n)], launches=int(launches[tag][1] * share))
    for name, row in k2_back.items():
        print(f"[time] card {card}: K2 {name} dx at (M, K, N, r) = "
              f"({row['M']}, {row['K']}, {row['N']}, {row['r']}) bf16 (K2 on "
              f"dy, W^T, B^T, A^T): {row['ms'] * 1e3:.1f} us/launch "
              f"({row['launches']} launches on its train path); bound "
              f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} = "
              f"{row['bound_ms'] / row['ms']:.1%} of bound; plain "
              f"{row['plain_ms'] * 1e3:.1f} us; torch.addmm(dy @ W^T, dy @ "
              f"B^T, A^T) {row['library_ms'] * 1e3:.1f} us (kernel / addmm "
              f"{row['ms'] / row['library_ms']:.2f}x); the W^T copy before "
              f"it {row['copy_ms'] * 1e3:.1f} us (bound "
              f"{row['copy_bound_ms'] * 1e3:.1f} us by bytes)")
    # ---- phase 8: the dry run and the step roofline (CPU counts; after
    # every timing, so its processes share no time with a measurement) ----
    _phase_dryrun(card)
    _phase_roofline(torch, card, train, train_ssm,
                    {**train_fam, **train_dense})
    print(json.dumps({"kernels": k1_entries + [
        # K2 runs at two shapes on each serving path, each with its own
        # entry: the prefill forward's launches and the 32 decode forwards'
        _entry(f"lora_matmul/{phase}", "lora_matmul.cu",
               "src/repro/kernels/lora_matmul.py:26", row["launches"],
               k2_err, row) for phase, row in k2_rows.items()] + [
        # K2's backward on the train paths: dx by K2 on (dy, W^T, B^T, A^T)
        _entry(f"lora_matmul/{name}", "lora_matmul.cu",
               "src/repro/kernels/lora_matmul.py:26", row["launches"],
               k2_dx_err, row) for name, row in k2_back.items()] + [
        _entry(name, "flash_attention.cu",
               "src/repro/kernels/flash_attention.py:28", row["launches"],
               k3_err, row) for name, row in k3_rows.items()] + [
        # K3's backward on each training path, under its own mask (the TPU
        # kernel has none: the backward of the function it computes)
        _entry("flash_attention/backward/" + name, "flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention.py:28", row["launches"],
               k3_bwd_err[name], row) for name, row in k3_back.items()] + [
        # K4 as its serving paths launch it, in the model's layout
        _entry(name, "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:23",
               rows["grouped"]["launches"], k4_err, rows["grouped"])
        for name, rows in k4_rows.items()] + [
        # K4's backward on [train-ssm]'s paths (the TPU kernel has none: the
        # backward of the function it computes)
        _entry("ssd_scan_backward/" + arch.split("-")[0], "ssd_scan_bwd.cu",
               "src/repro/kernels/ssd_scan.py:23", row["launches"],
               k4_bwd_err, row) for arch, row in k4_back.items()]}))
    print(f"[id] chip_smoke.py: {time.perf_counter() - t_main:.1f} s from "
          "the build on")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
