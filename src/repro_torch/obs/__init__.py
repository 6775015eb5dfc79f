"""Flight recorder, host side.

The capture path lives in the port's slot loops (``core/fast_sim``) and EG
loop (``core/selector``) as extra per-slot / per-job outputs behind the
``collect=`` flag; with ``collect=False`` (the default everywhere) the
loops run exactly the ops they ran without it. Port of the JAX package's
``obs`` (numpy, copied whole; same names):

* :mod:`repro_torch.obs.frame` — the ``TelemetryFrame`` view over the
  ``tel_*`` keys the engines emit;
* :mod:`repro_torch.obs.ledger` — folds frames into JSON-serializable
  metric reports (cost decomposition reconciled against reported
  utilities, preemption counts, fallback triggers and recoveries, selector
  convergence curves, the scenario grid's per-regime ledger);
* :mod:`repro_torch.obs.report` — renders a ledger as a textual dashboard.
"""
from repro_torch.obs.frame import (
    FALLBACK_KEYS,
    FLEET_KEYS,
    SLOT_KEYS,
    TEL_PREFIX,
    TelemetryFrame,
    frame_from_out,
    has_telemetry,
)
from repro_torch.obs.ledger import (
    SCHEMA_VERSION,
    cost_reconciliation,
    fallback_events,
    fleet_ledger,
    grid_ledger,
    pool_ledger,
    selection_ledger,
)
from repro_torch.obs.report import render

__all__ = [
    "TEL_PREFIX",
    "SLOT_KEYS",
    "FLEET_KEYS",
    "FALLBACK_KEYS",
    "fallback_events",
    "TelemetryFrame",
    "frame_from_out",
    "has_telemetry",
    "SCHEMA_VERSION",
    "cost_reconciliation",
    "pool_ledger",
    "fleet_ledger",
    "selection_ledger",
    "grid_ledger",
    "render",
]
