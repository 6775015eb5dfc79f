"""Scheduler core: market, forecasts, policy pool, job model, window
solver, pool simulator (one region and many), EG selector and the selection
engine; and the host reference chain (python policies, reference
simulators, offline optimum) the vectorized paths are held to. Re-exports
the names the reference's ``repro.core`` does but one: its ``throughput``
function, whose name there hides the ``core.throughput`` module, stays
``repro_torch.core.throughput.throughput`` here, so that the module keeps
its name. Also re-exports the pool simulator's sharded and seed-path entry
points and the fleet engine's."""
from repro_torch.core.engine import (
    SelectionResult,
    prepare_noisy_inputs,
    select_from_utilities,
    simulate_and_select,
)
from repro_torch.core.fast_sim import (
    simulate_one,
    simulate_pool_jobs_monolithic,
    simulate_pool_jobs_sharded,
    simulate_pool_monolithic,
    simulate_pool_regions_sharded,
)
from repro_torch.core.fleet import simulate_fleet, simulate_fleet_sharded
from repro_torch.core.job import (
    expected_progress,
    normalization_bounds,
    normalization_bounds_batch,
    normalize_utility,
    normalize_utility_batch,
    tilde_value,
    value_fn,
)
from repro_torch.core.market import (
    Trace,
    TraceStats,
    constant_trace,
    from_arrays,
    gather_windows,
    vast_like_trace,
)
from repro_torch.core.offline_opt import OfflineResult, solve_offline
from repro_torch.core.policies import (
    AHANP,
    AHANPParams,
    AHAP,
    AHAPParams,
    MSU,
    ODOnly,
    RSEL_AVAIL,
    RSEL_FIXED,
    RSEL_NAMES,
    RSEL_PRED,
    RSEL_PRICE,
    RandDeadline,
    RandDeadlineParams,
    RegionSelector,
    RegionSelectorParams,
    UP,
    rand_commit_frac,
    uniform_commit_frac,
)
from repro_torch.core.policy_pool import (
    PolicySpec,
    baseline_specs,
    paper_pool,
    rand_deadline_pool,
    region_pool,
    specs_to_arrays,
    uniform_rand_deadline_pool,
)
from repro_torch.core.predictor import (
    ARIMAPredictor,
    NoisyPredictor,
    PerfectPredictor,
    RegionalPredictor,
    forecast_errors,
    noisy_matrix_batch,
    true_future_batch,
)
from repro_torch.core.region_market import (
    RegionalMarket,
    RegionalSimResult,
    simulate_regional,
    vast_like_regions,
)
from repro_torch.core.selector import (
    EGState,
    best_policy,
    eg_init,
    init_selector,
    iters_to_half,
    regret,
    regret_bound,
    run_eg_scan,
    select,
    update,
)
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.throughput import calibrate, effective_work, mu_factor
from repro_torch.core.window_opt import (
    brute_force_window,
    solve_window,
    solve_window_batch,
    solve_window_numpy,
)
