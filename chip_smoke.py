#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repo root, with no arguments:

    python3 chip_smoke.py

It builds K1 (``src/repro_torch/kernels/csrc/window_dp.cu``) with nvcc for
sm_90a, holds it bit for bit against its plain PyTorch version on the card,
drives the paper's online policy selection (Fig. 9: four noise settings,
1000 jobs x ``paper_pool()``) through ``engine.simulate_and_select`` on the
card, checks winners against the JAX reference and the plain-DP run, and
times the kernel beside its bound. Any failed phase raises and the script
exits nonzero. Without a CUDA device, or without the repo beside it, it
exits nonzero and prints no result. Its last line is the device JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): device memory rate
# and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


def _compare_k1(name, slot_cost, gain, torch, window_dp, window_dp_ref):
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
    print(f"[k1] {name}: B={slot_cost.shape[0]} w1={slot_cost.shape[1]} "
          f"tn={slot_cost.shape[2] - 1} bit-equal")
    return err


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


def main() -> int:
    import torch

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
    from repro_torch.core.policy_pool import (baseline_specs, paper_pool,
                                              rand_deadline_pool,
                                              specs_to_arrays)
    from repro_torch.kernels import window_dp as k1
    from repro_torch.kernels.ref import window_dp_ref
    from repro_torch import workload

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    window_dp = k1.window_dp

    # ---- phase 1: identity and build ----
    card = _card_line()
    print(f"[id] card: {card}")
    print(f"[id] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path, log = k1.build()
    k1.load_library()
    build_s = time.perf_counter() - t0
    print(f"[id] K1 built in {build_s:.2f} s -> "
          f"{lib_path.relative_to(ROOT)}")
    for line in log.strip().splitlines():
        print(f"[nvcc] {line}")

    # ---- phase 2: K1 against its plain version on the card ----
    max_err = 0.0
    for b, w1, tn in ((1, 6, 16), (8, 6, 16), (13, 3, 5), (40, 1, 4)):
        c, g = _tables(b, w1, tn, b * 131 + w1, torch, dev)
        max_err = max(max_err, _compare_k1(f"test shape {(b, w1, tn)}", c,
                                           g, torch, window_dp,
                                           window_dp_ref))
    big_c, big_g = _tables(B_MAIN, W1, TN, 2024, torch, dev)
    max_err = max(max_err, _compare_k1("random tables", big_c, big_g, torch,
                                       window_dp, window_dp_ref))

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

    window_dp.launches = 0
    results, wall = {}, {}
    for setting in SETTINGS:
        before = window_dp.launches
        t0 = time.perf_counter()
        results[setting] = engine.simulate_and_select(
            pool, inputs[setting][0], workload.PAPER_TPUT,
            *inputs[setting][1:], return_utilities=True)
        wall[setting] = time.perf_counter() - t0
        if window_dp.launches - before != 10:
            _fail(f"{setting}: K1 launched {window_dp.launches - before} "
                  "times, expected 10 (one per market slot)")
    main_launches = window_dp.launches
    print(f"[main] K1 launches over the four settings: {main_launches}")

    # the same runs with the plain DP on the card; capture one slot's real
    # tables on the way
    captured = {"calls": 0}
    plain_solve = window_opt._solve_batch

    def capture(slot_cost, gain, backend):
        captured["calls"] += 1
        if captured["calls"] == 6:      # slot 5 of the first setting
            captured["tables"] = (slot_cost.clone(), gain.clone())
        return plain_solve(slot_cost, gain, backend)

    torch_wall = {}
    window_opt._solve_batch = capture
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
        window_opt._solve_batch = plain_solve
    real_c, real_g = captured["tables"]
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
    pool124 = specs_to_arrays(paper_pool() + rand_deadline_pool()
                              + baseline_specs())
    kinds = set(pool124["kind"].tolist())
    if kinds != {0, 1, 2, 3, 4, 5}:
        _fail(f"124-lane pool kinds {sorted(kinds)}")
    window_dp.launches = 0
    setting = SETTINGS[0]
    t0 = time.perf_counter()
    res124 = engine.simulate_and_select(
        pool124, inputs[setting][0], workload.PAPER_TPUT,
        *inputs[setting][1:], return_utilities=True)
    wall124 = time.perf_counter() - t0
    if window_dp.launches != 10:
        _fail(f"124-lane run launched K1 {window_dp.launches} times")
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

    # ---- phase 4: K1's time beside its bound and the plain DP ----
    for _ in range(3):
        window_dp(big_c, big_g)
    k1_ms = _event_ms(torch, lambda: window_dp(big_c, big_g), 25)
    k1_real_ms = _event_ms(torch, lambda: window_dp(real_c, real_g), 25)
    plain_ms = _event_ms(torch, lambda: window_dp_ref(big_c, big_g), 5)
    b, u1 = B_MAIN, W1 * TN + 1
    n_bytes = 4 * (b * W1 * (TN + 1) + b * u1 + b * W1 + b)
    n_ops = 2 * b * W1 * (TN + 1) * u1
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[time] card {card}: K1 {k1_ms * 1e3:.1f} us/launch at "
          f"B={b} (real slot tables {k1_real_ms * 1e3:.1f} us); bound "
          f"{bound_ms * 1e3:.1f} us by {bound_by} (bytes {bytes_ms * 1e3:.1f}"
          f" us for {n_bytes / 1e6:.2f} MB, operations {ops_ms * 1e3:.1f} us "
          f"for {n_ops / 1e9:.3f} G) = {bound_ms / k1_ms:.1%} of bound; "
          f"plain torch DP {plain_ms * 1e3:.1f} us; library_ms null (no "
          "single PyTorch call computes a min-plus DP)")
    print("[time] engine per setting: " + "; ".join(
        f"{k} {lv}: {wall[(k, lv)]:.3f} s, "
        f"{N_JOBS * n_pol / wall[(k, lv)]:.0f} cells/s"
        for k, lv in SETTINGS))

    print(json.dumps({"kernels": [{
        "name": "window_dp",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window_dp.cu",
        "replaces": "src/repro/kernels/window_dp.py:36",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
