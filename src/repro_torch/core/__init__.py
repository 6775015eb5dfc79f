"""Scheduler core: market, forecasts, policy pool, job model, window
solver, pool simulator, EG selector and the selection engine."""
