"""Scheduler core: market, forecasts, policy pool, job model, window
solver, pool simulator (one region and many), EG selector and the selection
engine; and the host reference chain (python policies, reference
simulators, offline optimum) the vectorized paths are held to."""
