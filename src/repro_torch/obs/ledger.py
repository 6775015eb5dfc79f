"""Fold telemetry frames into structured, JSON-serializable metric ledgers.
Port of the JAX package's ``obs/ledger.py`` (numpy, copied whole).

Every ledger function returns a plain-python dict (``json.dumps``
round-trips it) with a shared envelope: ``schema_version``, ``kind``, a
``shape`` block, and a ``cost_reconciliation`` block proving the per-slot
cost split sums back to the engine's reported totals:

    cost == sum_t tel_spot_cost + sum_t tel_od_cost + termination_cost
    utility == value_fn(completion_time) - cost

where ``termination_cost = p_o * n_max * dt`` with ``dt = max(L - z_ddl,
0) / (alpha * n_max + beta)`` — the f32-exact mirror of
``fast_sim._finalize``. Residuals are carried in the ledger (f32
accumulation on device vs f64 sums here), so a consumer can see the
tolerance instead of trusting it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.obs import frame as _frame

SCHEMA_VERSION = 1

# downsample cap for curves stored in the ledger (full traces stay in the
# arrays the caller holds; the ledger is the summary artifact)
CURVE_POINTS = 64


def _py(x):
    """numpy scalar/array -> plain python (json-serializable)."""
    x = np.asarray(x)
    if x.ndim == 0:
        return x.item()
    return x.tolist()


def _job_bcast(x, like: np.ndarray) -> np.ndarray:
    """Broadcast a per-job (J,) field against a result leaf whose leading
    axis is jobs ((J, P) pool / (J,) fleet / () single)."""
    x = np.asarray(x, np.float64)
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def _curve(values, n_points: int = CURVE_POINTS):
    """Downsample a 1-D trace to <= n_points (index, value) pairs, always
    keeping the final point."""
    v = np.asarray(values, np.float64)
    k = v.shape[0]
    if k == 0:
        return {"index": [], "value": []}
    idx = np.unique(np.concatenate([
        np.linspace(0, k - 1, min(n_points, k)).astype(np.int64), [k - 1]
    ]))
    return {"index": idx.tolist(), "value": v[idx].tolist()}


def cost_reconciliation(out: dict, jobs, tput) -> dict:
    """Reconcile the telemetry cost split against the engine's totals.

    ``out`` — a ``collect=True`` result dict; ``jobs`` — the stacked
    JobArrays the run used (leading jobs axis matching ``out``); ``tput`` —
    its ThroughputConfig. Residuals are max-abs over every (job, lane)
    cell, in utility units."""
    cost = np.asarray(out["cost"], np.float64)
    spot = np.asarray(out["tel_spot_cost"], np.float64).sum(axis=-1)
    od = np.asarray(out["tel_od_cost"], np.float64).sum(axis=-1)
    z = np.asarray(out["z_ddl"], np.float64)
    done = np.asarray(out["completed"], bool)
    wl = _job_bcast(jobs.workload, cost)
    n_max = _job_bcast(jobs.n_max, cost)
    p_o = _job_bcast(jobs.p_o, cost)
    h_max = float(tput.alpha) * n_max + float(tput.beta)
    term = np.where(done, 0.0, p_o * n_max * np.maximum(wl - z, 0.0) / h_max)
    cost_resid = cost - (spot + od + term)
    util_resid = (np.asarray(out["value"], np.float64) - cost
                  - np.asarray(out["utility"], np.float64))
    return {
        "total_cost": float(cost.sum()),
        "spot_cost": float(spot.sum()),
        "od_cost": float(od.sum()),
        "termination_cost": float(term.sum()),
        "spot_share": float(spot.sum() / max(cost.sum(), 1e-12)),
        "max_abs_cost_residual": float(np.abs(cost_resid).max()),
        "max_abs_utility_residual": float(np.abs(util_resid).max()),
    }


def _event_aggregates(fr: _frame.TelemetryFrame, axis) -> dict:
    """Event/cost aggregates reduced over ``axis`` (per-lane or per-job)."""
    slots = fr.active.sum(axis=-1)
    return {
        "mean_active_slots": _py(slots.mean(axis=axis)),
        "preemptions_mean": _py(
            fr.preempted.sum(axis=-1).mean(axis=axis).astype(np.float64)),
        "reconfig_up_mean": _py(
            fr.reconfig_up.sum(axis=-1).mean(axis=axis).astype(np.float64)),
        "reconfig_down_mean": _py(
            fr.reconfig_down.sum(axis=-1).mean(axis=axis).astype(np.float64)),
    }


def fallback_events(active) -> dict:
    """Trigger/recovery accounting over a ``tel_fallback`` series (any
    leading axes, trailing time axis). A *trigger* is the monitor arming
    (rising edge, plus rows already armed at slot 0); a *recovery* is the
    monitor standing down (falling edge). The reconciliation invariant —
    every trigger is matched by a recovery or is still open at the end —
    is carried as ``events_reconciled`` so a consumer can check it held."""
    act = np.asarray(active, bool)
    if act.size == 0:
        return {"triggers": 0, "recoveries": 0, "open_at_end": 0,
                "active_fraction": 0.0, "events_reconciled": True}
    d = np.diff(act.astype(np.int8), axis=-1)
    triggers = int((d > 0).sum() + act[..., 0].sum())
    recoveries = int((d < 0).sum())
    open_at_end = int(act[..., -1].sum())
    return {
        "triggers": triggers,
        "recoveries": recoveries,
        "open_at_end": open_at_end,
        "active_fraction": float(act.mean()),
        "events_reconciled": triggers == recoveries + open_at_end,
    }


def migration_reconciliation(out: dict) -> dict:
    """Reconcile the per-slot migration series against the region engine's
    summary leaves (a ``simulate_pool_regions[_sharded]`` ``collect=True``
    run).

    Two invariants are checked, not trusted:

    * ``events_reconciled`` — per (job, lane), ``tel_migration`` slot sums
      equal the ``migrations`` result leaf exactly (every committed switch
      the scan counted shows up as exactly one telemetry event);
    * ``series_matches_leaf`` — ``tel_region`` is bitwise the ``region``
      occupancy leaf (the telemetry path and the result path sampled the
      same post-step region).

    Also summarizes occupancy: fraction of slot-samples spent in each
    region, and the mean committed switches per (job, lane)."""
    mig_series = np.asarray(out["tel_migration"], bool)
    mig_leaf = np.asarray(out["migrations"], np.int64)
    reg_series = np.asarray(out["tel_region"], np.int64)
    reg_leaf = np.asarray(out["region"], np.int64)
    per_cell = mig_series.sum(axis=-1).astype(np.int64)
    n_regions = int(reg_series.max()) + 1 if reg_series.size else 0
    occupancy = [float((reg_series == r).mean()) for r in range(n_regions)]
    return {
        "total_migrations": int(mig_leaf.sum()),
        "migrations_mean": float(mig_leaf.mean()) if mig_leaf.size else 0.0,
        "events_reconciled": bool(np.array_equal(per_cell, mig_leaf)),
        "series_matches_leaf": bool(np.array_equal(reg_series, reg_leaf)),
        "region_occupancy": occupancy,
    }


def _migration_block(out: dict) -> Optional[dict]:
    if "tel_migration" not in out or "migrations" not in out:
        return None
    return migration_reconciliation(out)


def _fallback_block(fr: _frame.TelemetryFrame) -> Optional[dict]:
    if fr.fallback_active is None:
        return None
    block = fallback_events(fr.fallback_active)
    block["pred_err_max"] = float(np.asarray(fr.pred_err).max())
    block["pred_err_final_mean"] = float(
        np.asarray(fr.pred_err, np.float64)[..., -1].mean())
    return block


def pool_ledger(out: dict, jobs, tput, lane_names: Optional[Sequence[str]] =
                None) -> dict:
    """Ledger for a ``simulate_pool_jobs[_sharded]`` collect run.

    ``out`` leaves are (J, P[, T]); per-lane aggregations reduce over the
    jobs axis. ``lane_names`` (length P) labels the per-lane block. Region
    runs (``simulate_pool_regions[_sharded]``) get a ``migration`` block —
    :func:`migration_reconciliation` over their ``tel_region`` /
    ``tel_migration`` series."""
    fr = _frame.frame_from_out(out)
    util = np.asarray(out["utility"], np.float64)     # (J, P)
    cost = np.asarray(out["cost"], np.float64)
    spot = fr.spot_cost.sum(axis=-1).astype(np.float64)
    od = fr.od_cost.sum(axis=-1).astype(np.float64)
    n_jobs, n_lanes = util.shape
    per_lane = {
        "mean_utility": _py(util.mean(axis=0)),
        "mean_cost": _py(cost.mean(axis=0)),
        "mean_spot_cost": _py(spot.mean(axis=0)),
        "mean_od_cost": _py(od.mean(axis=0)),
        "completion_rate": _py(
            np.asarray(out["completed"]).mean(axis=0).astype(np.float64)),
        **_event_aggregates(fr, axis=0),
    }
    if lane_names is not None:
        per_lane["name"] = list(lane_names)
    ledger = {
        "schema_version": SCHEMA_VERSION,
        "kind": "pool",
        "shape": {"n_jobs": n_jobs, "n_lanes": n_lanes,
                  "n_slots": int(fr.active.shape[-1])},
        "cost_reconciliation": cost_reconciliation(out, jobs, tput),
        "per_lane": per_lane,
    }
    fb = _fallback_block(fr)
    if fb is not None:
        ledger["fallback"] = fb
    mig = _migration_block(out)
    if mig is not None:
        ledger["migration"] = mig
    return ledger


def fleet_ledger(out: dict, jobs, tput, supply=None) -> dict:
    """Ledger for a ``simulate_fleet[_sharded]`` collect run.

    ``out`` leaves are (J[, T]). Adds the waterfall block: per-job demand
    vs grant totals, starvation incidence (fraction of jobs with at least
    one live slot granted strictly less than demanded), and — when the
    supply trace is passed — the per-slot oversubscription check
    (sum of grants minus supply, must never exceed 0)."""
    fr = _frame.frame_from_out(out)
    util = np.asarray(out["utility"], np.float64)     # (J,)
    demand = fr.demand.astype(np.int64)
    grant = fr.grant.astype(np.int64)
    starved_slots = fr.starved.sum(axis=-1).astype(np.int64)
    ledger = {
        "schema_version": SCHEMA_VERSION,
        "kind": "fleet",
        "shape": {"n_jobs": int(util.shape[0]),
                  "n_slots": int(fr.active.shape[-1])},
        "cost_reconciliation": cost_reconciliation(out, jobs, tput),
        "waterfall": {
            "total_demand": int(demand.sum()),
            "total_granted": int(grant.sum()),
            "grant_ratio": float(grant.sum() / max(demand.sum(), 1)),
            "starvation_incidence": float((starved_slots > 0).mean()),
            "starved_slots_total": int(starved_slots.sum()),
        },
        "per_job": {
            "utility": _py(util),
            "cost": _py(np.asarray(out["cost"], np.float64)),
            "spot_cost": _py(fr.spot_cost.sum(axis=-1).astype(np.float64)),
            "od_cost": _py(fr.od_cost.sum(axis=-1).astype(np.float64)),
            "demand": _py(demand.sum(axis=-1)),
            "granted": _py(grant.sum(axis=-1)),
            "starved_slots": _py(starved_slots),
            **_event_aggregates(fr, axis=()),
        },
    }
    if supply is not None:
        over = grant.sum(axis=0) - np.asarray(supply, np.int64)
        ledger["waterfall"]["max_oversubscription"] = int(over.max())
    fb = _fallback_block(fr)
    if fb is not None:
        ledger["fallback"] = fb
    return ledger


def selection_ledger(result) -> dict:
    """Ledger for an ``engine.simulate_and_select`` run (a SelectionResult).

    Always carries the convergence curve (leader weight + cumulative
    regret per job, downsampled); the entropy curve and top-policy switch
    trace appear when the run collected (``collect=True``)."""
    m = int(np.shape(result.state.weights)[0])
    ledger = {
        "schema_version": SCHEMA_VERSION,
        "kind": "selection",
        "shape": {"n_jobs": int(result.n_jobs), "n_policies": m},
        "best_policy": int(result.best_policy()),
        "iters_to_half": int(result.iters_to_half()),
        "regret_ratio": float(result.regret_ratio()),
        "convergence": {
            "max_weight": _curve(result.max_weight),
            "regret": _curve(result.regret),
        },
    }
    if result.entropy is not None:
        ledger["convergence"]["entropy"] = _curve(result.entropy)
        ledger["entropy_final"] = float(np.asarray(result.entropy)[-1])
        ledger["entropy_uniform"] = float(np.log(m))
    if result.top_policy is not None:
        top = np.asarray(result.top_policy, np.int64)
        switch = np.flatnonzero(np.diff(top)) + 1
        ledger["top_policy"] = {
            # run-length encoding: the leader after job 0, then every switch
            "policy": [int(top[0])] + [int(top[s]) for s in switch],
            "since_job": [0] + switch.tolist(),
            "n_switches": int(switch.shape[0]),
        }
    return ledger


def grid_ledger(regimes: List[dict], util: np.ndarray, sim_out: dict, jobs,
                tputs: Sequence, n_jobs: int,
                lane_names: Optional[Sequence[str]] = None) -> dict:
    """Per-regime telemetry ledger for the scenario grid.

    ``regimes`` — one metadata dict per regime (must carry ``key``);
    ``util`` — the (R, K, M) raw-utility tensor; ``sim_out`` — the merged
    collect dict from ``evaluate_grid(..., collect=True)`` ((R*K, M, ...)
    leaves, regime-major); ``jobs`` — the stacked (R*K,) JobArrays;
    ``tputs`` — the per-regime ThroughputConfig (the mu axis). Each
    regime's entry reconciles its own cost decomposition and summarizes
    the winner lane's flight record — the *evidence* behind the winner
    map."""
    from repro_torch.core import fast_sim

    R, K, M = util.shape
    assert len(regimes) == R and len(tputs) == R
    per_regime = []
    worst_cost = worst_util = 0.0
    for r, meta in enumerate(regimes):
        sl = {k: np.asarray(v)[r * K:(r + 1) * K] for k, v in sim_out.items()}
        jb = fast_sim.slice_jobs(jobs, r * K, (r + 1) * K)
        recon = cost_reconciliation(sl, jb, tputs[r])
        worst_cost = max(worst_cost, recon["max_abs_cost_residual"])
        worst_util = max(worst_util, recon["max_abs_utility_residual"])
        fr = _frame.frame_from_out(sl)
        mean_u = util[r].mean(axis=0)                 # (M,)
        w = int(mean_u.argmax())
        lane = lambda a: _py(np.asarray(a, np.float64)[:, w].mean())
        entry = {
            **meta,
            "winner_idx": w,
            "winner_mean_utility": float(mean_u[w]),
            "cost_reconciliation": recon,
            "winner_lane": {
                "mean_cost": lane(np.asarray(sl["cost"])),
                "mean_spot_cost": lane(fr.spot_cost.sum(axis=-1)),
                "mean_od_cost": lane(fr.od_cost.sum(axis=-1)),
                "completion_rate": lane(np.asarray(sl["completed"])),
                "preemptions_mean": lane(fr.preempted.sum(axis=-1)),
                "reconfig_mean": lane((fr.reconfig_up
                                       | fr.reconfig_down).sum(axis=-1)),
            },
            "pool": {
                "spot_share": recon["spot_share"],
                "preempt_rate": float(fr.preempted.mean()),
                "completion_rate": float(np.asarray(sl["completed"]).mean()),
            },
        }
        if lane_names is not None:
            entry["winner"] = str(lane_names[w])
        per_regime.append(entry)
    return {
        "schema_version": SCHEMA_VERSION,
        "kind": "scenario_grid",
        "shape": {"n_regimes": R, "jobs_per_regime": K, "n_lanes": M},
        "max_abs_cost_residual": worst_cost,
        "max_abs_utility_residual": worst_util,
        "per_regime": per_regime,
    }
