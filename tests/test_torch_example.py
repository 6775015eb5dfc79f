"""The port's policy-selection example (``examples/policy_selection_torch.py``)
run as a program, against the same loop through the JAX package's functions
(the loop of ``examples/policy_selection.py``, cut to 20 jobs).

The final leader is exact. The regret is printed to two decimals; the
utilities of the two packages agree to an ulp of the slot bill (ROADMAP
Queue 3, entry 3), so the printed regret is held to its rounding."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro.configs.base import JobConfig, ThroughputConfig
from repro.core import fast_sim
from repro.core.job import normalize_utility
from repro.core.market import vast_like_trace
from repro.core.policy_pool import baseline_specs, paper_pool, specs_to_arrays
from repro.core.predictor import NoisyPredictor
from repro.core.selector import (best_policy, init_selector, regret,
                                 regret_bound, select, update)

ROOT = Path(__file__).resolve().parents[1]
N_JOBS = 20


def _reference_loop(k_jobs):
    """examples/policy_selection.py's loop on the JAX package."""
    tput = ThroughputConfig(mu1=0.9, mu2=0.95)
    pool = paper_pool() + baseline_specs()
    arrs = specs_to_arrays(pool)
    market = vast_like_trace(seed=3, days=40, mean_price=0.7,
                             price_sigma=0.5, avail_mean=5.5,
                             avail_season_amp=3.0)
    rng = np.random.default_rng(0)
    st = init_selector(len(pool), k_jobs)
    for k in range(k_jobs):
        job = JobConfig(workload=float(rng.uniform(70, 120)), deadline=10,
                        n_min=int(rng.integers(1, 4)),
                        n_max=int(rng.integers(12, 17)), value=120.0)
        tr = market.window(int(rng.integers(0, len(market) - 11)), 11)
        pred = NoisyPredictor(tr, "fixed_uniform", 0.15, seed=k).matrix(5)
        prices, avail, pm = fast_sim.prepare_inputs(tr, pred, job.deadline)
        select(st, rng)
        out = fast_sim.simulate_pool(arrs, fast_sim.JobArrays.of(job), tput,
                                     prices, avail, pm)
        st = update(st, np.asarray(normalize_utility(
            job, np.asarray(out["utility"]))))
    return pool, st


def test_example_matches_reference_loop():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "policy_selection_torch.py"),
         "--jobs", str(N_JOBS), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    leader = re.search(rf"selected policy after {N_JOBS} jobs: (\S+) "
                       r"\(weight ([0-9.]+)\)", proc.stdout)
    final = re.search(r"final regret ([0-9.]+) <= bound ([0-9.]+): (\w+)",
                      proc.stdout)
    assert leader and final, proc.stdout

    pool, st = _reference_loop(N_JOBS)
    b = best_policy(st)
    assert leader.group(1) == pool[b].name
    assert float(leader.group(2)) == round(float(st.weights[b]), 3)
    assert abs(float(final.group(1)) - regret(st)) <= 0.005 + 1e-6
    assert float(final.group(2)) == round(regret_bound(len(pool), N_JOBS), 2)
    assert final.group(3) == str(regret(st) <= regret_bound(len(pool),
                                                             N_JOBS))


def _table(stdout):
    """The policy table quickstart prints: {name: (utility, cost, T, done,
    allocation)} as strings, and the OPT row."""
    rows = {}
    for line in stdout.splitlines():
        m = re.match(r"(\w+)\s+(-?[0-9.]+)\s+(-?[0-9.]+)\s+([0-9.]+)\s+"
                     r"(True|False)\s+(\[.*\])$", line)
        if m:
            rows[m.group(1)] = m.groups()[1:]
        m = re.match(r"OPT\s+(-?[0-9.]+)\s+(-?[0-9.]+)\s+(\[.*\])$", line)
        if m:
            rows["OPT"] = m.groups()
    return rows


def test_quickstart_matches_reference_quickstart():
    """``examples/quickstart_torch.py --device cpu`` against the JAX
    package's ``examples/quickstart.py``: ARIMA, the five python policies
    through the reference simulator and the offline optimum print the same
    market statistics and the same table."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for script, args in (("quickstart_torch.py", ["--device", "cpu"]),
                         ("quickstart.py", [])):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script), *args],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs[script] = proc.stdout
    got, want = runs["quickstart_torch.py"], runs["quickstart.py"]
    assert got.splitlines()[0].startswith("market: TraceStats(")
    assert got.splitlines()[0] == want.splitlines()[0]
    table = _table(got)
    assert set(table) == {"ahap", "ahanp", "od_only", "msu", "up", "OPT"}
    assert table == _table(want)


def _multijob_table(stdout):
    """The multi-job rows serve_and_multijob prints: {job: (utility, cost,
    T, on-time)} as strings."""
    rows = {}
    for line in stdout.split("multi-job")[-1].splitlines():
        m = re.match(r"\s*([\w-]+)\s+(-?[0-9.]+)\s+(-?[0-9.]+)\s+([0-9.]+)\s+"
                     r"(True|False)$", line)
        if m:
            rows[m.group(1)] = m.groups()[1:]
    return rows


def test_serve_and_multijob_matches_reference_example():
    """``examples/serve_and_multijob_torch.py --device cpu`` against the JAX
    package: the multi-job table equals ``examples/serve_and_multijob.py``'s
    (the same market, ARIMA forecasts, AHAP jobs and least-slack-first
    scheduler), and the served tokens equal the JAX ServingEngine's on the
    same numpy weights (the JAX example draws its own weights from a JAX
    key, so its tokens are not comparable)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jsmoke
    from repro.serve import Request as JRequest
    from repro.serve import ServingEngine as JServingEngine
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for script, args in (("serve_and_multijob_torch.py", ["--device", "cpu"]),
                         ("serve_and_multijob.py", [])):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script), *args],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs[script] = proc.stdout
    got = runs["serve_and_multijob_torch.py"]
    table = _multijob_table(got)
    assert set(table) == {"tight", "loose", "late-arrival"}
    assert table == _multijob_table(runs["serve_and_multijob.py"])

    served = [[int(t) for t in m.group(1).split(", ")] for m in
              re.finditer(r"-> generated \[([0-9, ]+)\]", got)]
    cfg = jsmoke("mixtral-8x7b")
    vals = convert.random_model_params(get_smoke_config("mixtral-8x7b"), 0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12))
    want = JServingEngine(cfg, jax.tree.map(jnp.asarray, vals),
                          max_len=128).generate_batch(
        [JRequest(p, 8) for p in prompts])
    assert served == [w.tolist() for w in want]


def test_market_forecast_prints_reference_figures():
    """``examples/market_forecast_torch.py`` against the JAX package's
    ``examples/market_forecast.py``: the trace statistics, the persistence
    and ARIMA MAPE by horizon, ARIMA's availability MAPE and the four
    noise regimes' MAPE print the same figures, line for line (both
    forecast chains are host numpy)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for script in ("market_forecast_torch.py", "market_forecast.py"):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script)], env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs[script] = proc.stdout
    got = runs["market_forecast_torch.py"]
    horizons = re.findall(r"^\s*([1-5])\s+([0-9.]+)\s+([0-9.]+)$", got,
                          re.MULTILINE)
    assert [h for h, _, _ in horizons] == ["1", "2", "3", "4", "5"]
    assert re.search(r"availability MAPE \(ARIMA\): \[[0-9., ]+\]", got)
    assert len(re.findall(r"^  \w+_\w+\s+[0-9.]+$", got, re.MULTILINE)) == 4
    assert got == runs["market_forecast.py"]
