"""Spot market forecasting (paper Fig. 3): ARIMA vs persistence vs the four
noise regimes, on a 10-day Vast.ai-like A100 trace, on the PyTorch / CUDA
port.

    PYTHONPATH=src python examples/market_forecast_torch.py

The forecasters are host code (numpy), so nothing here touches the card.
The same script as ``examples/market_forecast.py`` (the JAX package's),
figure for figure.
"""
import numpy as np

from repro_torch.core.market import TraceStats, vast_like_trace
from repro_torch.core.predictor import (
    ARIMAPredictor,
    NOISE_KINDS,
    NoisyPredictor,
    forecast_errors,
    mape,
)

trace = vast_like_trace(seed=6, days=10)
print("trace:", TraceStats.of(trace))

H = 5
arima = forecast_errors(trace, ARIMAPredictor(trace), H)
T = len(trace)
persist_price = [mape(trace.prices[: T - j], trace.prices[j:])
                 for j in range(1, H + 1)]

print("\nprice MAPE by horizon (30-min steps):")
print(f"{'h':>3s} {'persistence':>12s} {'ARIMA':>8s}")
for j in range(H):
    print(f"{j+1:3d} {persist_price[j]:12.3f} {arima['price'][j]:8.3f}")

print(f"\navailability MAPE (ARIMA): "
      f"{[round(x, 3) for x in arima['avail']]}")

print("\nnoise regimes at level=0.3 (mean price MAPE over horizons):")
for kind in NOISE_KINDS:
    e = forecast_errors(trace, NoisyPredictor(trace, kind, 0.3, seed=0), H)
    print(f"  {kind:18s} {np.mean(e['price']):.3f}")
