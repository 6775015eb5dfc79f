"""Chaos engineering for the scheduling engines: seeded fault injection
over market traces / forecast stacks (:mod:`repro_torch.chaos.faults`) and
the online prediction-failure fallback the pool simulator degrades to when
its forecasts go bad (:mod:`repro_torch.chaos.fallback`). Port of the JAX
package's ``chaos`` (same names); driven end to end on the card by
chip_smoke.py's ``[chaos]`` phase."""
from repro_torch.chaos.fallback import FallbackConfig
from repro_torch.chaos.faults import (
    FAULT_KINDS,
    FORECAST_KINDS,
    MARKET_KINDS,
    FaultSpec,
    blackout_schedule,
    inject,
    inject_forecasts,
    inject_market,
    storm_schedule,
    sync_present,
    window_mask,
)

__all__ = [
    "FAULT_KINDS",
    "MARKET_KINDS",
    "FORECAST_KINDS",
    "FaultSpec",
    "FallbackConfig",
    "window_mask",
    "inject_market",
    "inject_forecasts",
    "sync_present",
    "inject",
    "storm_schedule",
    "blackout_schedule",
]
