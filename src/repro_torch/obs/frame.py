"""TelemetryFrame: the typed host-side view over the ``tel_*`` series.
Port of the JAX package's ``obs/frame.py`` (numpy, copied whole).

The engines emit telemetry as FLAT ``tel_*`` keys in their result dicts —
one extra stacked scan output per series, same leading axes as the
``n_od``/``n_spot`` histories ((P, T) per-lane, (J, P, T) pool-of-jobs,
(J, T) fleet) — so every piece of existing result plumbing
(``fast_sim._scatter_merge``, shard_map out_specs, padding drops, the
fleet's submission-order reorder) carries them with zero special cases.
This module assembles the flat keys into one NamedTuple on the host.

Per-slot semantics (all sampled AFTER the slot executed):

==============  ============================================================
``spot_cost``   f32, ``n_spot * price`` on active slots (0 otherwise)
``od_cost``     f32, ``n_od * p_o`` on active slots
``progress``    f32, cumulative work ``z`` at the end of the slot
``active``      bool, the slot executed (live and not yet complete)
``reconfig_up``   bool, allocation grew vs the previous slot (pays mu1)
``reconfig_down`` bool, allocation shrank vs the previous slot (pays mu2)
``preempted``   bool, shrink forced by supply: the slot's available spot
                (fleet: the waterfall grant) fell below last slot's
                allocation — the spot-market preemption event GFS-style
                predictive management keys on
==============  ============================================================

Fleet runs add the waterfall series (``None`` for pool runs):

==============  ============================================================
``demand``      i32, spot demand at full supply (pre-waterfall)
``grant``       i32, spot actually granted by the waterfall
``slack``       f32, the least-slack-first key (0 where not live)
``rank``        i32, position in the demanders-only grant order
                (-1 when the job demanded nothing that slot)
``starved``     bool, live, demanded, and granted strictly less
==============  ============================================================

Runs with the prediction-failure monitor armed (``fallback=`` a
``repro_torch.chaos.FallbackConfig``) add two more series (``None`` otherwise;
cheap lanes, which carry no monitor, report all-zero rows):

==================  ========================================================
``fallback_active`` bool, the lane ran the prediction-free AHANP rule this
                    slot (its forecast-error EWMA exceeded the threshold)
``pred_err``        f32, that realized-forecast-error EWMA after the slot
==================  ========================================================

Region runs (``simulate_pool_regions[_sharded]`` with ``collect=True``)
add the migration series (``None`` for single-region runs):

==============  ============================================================
``region``      i32, the region occupied this slot (post region-selector
                step — matches the ``region`` result leaf exactly)
``migrated``    bool, a cross-region switch was *committed* this slot (the
                checkpoint transfer starts; the lane holds zero instances
                for the next ``delta_mig`` slots). Slot sums equal the
                ``migrations`` result leaf — ``obs.ledger.
                migration_reconciliation`` checks that invariant.
==============  ============================================================
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

TEL_PREFIX = "tel_"

# slot series every engine emits (fast_sim._slot_telemetry order)
SLOT_KEYS = ("tel_spot_cost", "tel_od_cost", "tel_progress", "tel_active",
             "tel_up", "tel_down", "tel_preempt")
# waterfall series only the fleet engine emits
FLEET_KEYS = ("tel_demand", "tel_grant", "tel_slack", "tel_rank",
              "tel_starved")
# prediction-failure monitor series, only when fallback= is armed
FALLBACK_KEYS = ("tel_fallback", "tel_pred_err")
# migration series only the region engine emits (fast_sim._TEL_REGION)
REGION_KEYS = ("tel_region", "tel_migration")


class TelemetryFrame(NamedTuple):
    """Host-numpy per-slot series; leading axes follow the source engine."""
    n_spot: np.ndarray
    n_od: np.ndarray
    spot_cost: np.ndarray
    od_cost: np.ndarray
    progress: np.ndarray
    active: np.ndarray
    reconfig_up: np.ndarray
    reconfig_down: np.ndarray
    preempted: np.ndarray
    demand: Optional[np.ndarray] = None
    grant: Optional[np.ndarray] = None
    slack: Optional[np.ndarray] = None
    waterfall_rank: Optional[np.ndarray] = None
    starved: Optional[np.ndarray] = None
    fallback_active: Optional[np.ndarray] = None
    pred_err: Optional[np.ndarray] = None
    region: Optional[np.ndarray] = None
    migrated: Optional[np.ndarray] = None


def has_telemetry(out: dict) -> bool:
    """Whether ``out`` came from a ``collect=True`` run."""
    return all(k in out for k in SLOT_KEYS)


def frame_from_out(out: dict) -> TelemetryFrame:
    """Assemble a TelemetryFrame from an engine result dict (``collect=True``
    run of ``simulate_pool[_jobs][_sharded]`` / ``simulate_fleet[_sharded]``
    / a ``SelectionResult.sim_out``). Raises KeyError if the run did not
    collect."""
    missing = [k for k in SLOT_KEYS if k not in out]
    if missing:
        raise KeyError(
            f"result has no telemetry ({missing[0]} absent) — "
            "was the engine called with collect=True?"
        )
    a = lambda k: np.asarray(out[k])
    return TelemetryFrame(
        n_spot=a("n_spot"), n_od=a("n_od"),
        spot_cost=a("tel_spot_cost"), od_cost=a("tel_od_cost"),
        progress=a("tel_progress"), active=a("tel_active"),
        reconfig_up=a("tel_up"), reconfig_down=a("tel_down"),
        preempted=a("tel_preempt"),
        demand=a("tel_demand") if "tel_demand" in out else None,
        grant=a("tel_grant") if "tel_grant" in out else None,
        slack=a("tel_slack") if "tel_slack" in out else None,
        waterfall_rank=a("tel_rank") if "tel_rank" in out else None,
        starved=a("tel_starved") if "tel_starved" in out else None,
        fallback_active=a("tel_fallback") if "tel_fallback" in out else None,
        pred_err=a("tel_pred_err") if "tel_pred_err" in out else None,
        region=a("tel_region") if "tel_region" in out else None,
        migrated=a("tel_migration") if "tel_migration" in out else None,
    )
