"""Spot market model: price/availability traces with Vast.ai-like statistics.

The paper (Fig. 2) collected 10 days of A100 spot data from Vast.ai at
30-minute slots and observed (a) a strong diurnal availability cycle,
(b) median price ~= 60% of the P90 price, (c) availability capped at a small
regional pool (normalized to [0, 16]). ``vast_like_trace`` reproduces those
statistics with a seasonal + AR(1) lognormal price process and a negatively
correlated availability process; ``TraceStats`` verifies the calibration
(tests + benchmarks/fig2).

A ``Trace`` describes ONE spot region; ``season_phase_slots`` below is the
knob that shifts its diurnal cycle. This module is a copy of the JAX
package's numpy-only ``core/market.py`` and must stay bit-equal to it
(pinned in tests/test_torch_host.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Trace:
    prices: np.ndarray          # (T,) spot price, on-demand normalized to 1.0
    avail: np.ndarray           # (T,) int, available spot instances
    slot_seconds: float = 1800.0
    slots_per_day: int = 48
    meta: dict = field(default_factory=dict)

    def __len__(self):
        return len(self.prices)

    def window(self, t0: int, length: int) -> "Trace":
        if t0 < 0 or length < 0 or t0 + length > len(self.prices):
            raise ValueError(
                f"window [{t0}, {t0 + length}) out of bounds for trace of "
                f"length {len(self.prices)}"
            )
        return Trace(
            self.prices[t0 : t0 + length],
            self.avail[t0 : t0 + length],
            self.slot_seconds,
            self.slots_per_day,
            dict(self.meta, t0=t0),
        )


def require_finite(name: str, arr) -> None:
    """Reject NaN/inf before they reach the engines, where they
    would propagate silently through the slot loops as garbage utilities.
    The error names the offender and where it first appears."""
    arr = np.asarray(arr)
    if not np.issubdtype(arr.dtype, np.floating):
        return
    bad = ~np.isfinite(arr)
    if bad.any():
        first = np.unravel_index(int(np.argmax(bad)), arr.shape)
        raise ValueError(
            f"{name} contains {int(bad.sum())} non-finite value(s) "
            f"(NaN/inf), first at index {tuple(int(i) for i in first)}"
        )


def gather_windows(trace: Trace, t0s, length: int):
    """Batched :meth:`Trace.window`: gather K windows of ``length`` slots in
    one fancy-indexing pass — ``(prices (K, length), avail (K, length))``.
    Same bounds rule as ``window`` (every [t0, t0+length) must lie inside
    the trace). The row-k arrays equal ``trace.window(t0s[k], length)``'s;
    this is what core.engine's prep uses instead of a per-job window loop."""
    t0s = np.asarray(t0s, np.int64)
    if length < 0 or (t0s.size and (
            int(t0s.min()) < 0 or int(t0s.max()) + length > len(trace))):
        raise ValueError(
            f"windows of length {length} at t0 in [{t0s.min()}, {t0s.max()}] "
            f"out of bounds for trace of length {len(trace)}"
        )
    require_finite("trace.prices", trace.prices)
    require_finite("trace.avail", trace.avail)
    idx = t0s[:, None] + np.arange(length)[None, :]
    return trace.prices[idx], trace.avail[idx]


@dataclass
class TraceStats:
    price_median: float
    price_p90: float
    median_over_p90: float
    avail_mean: float
    avail_day_night_ratio: float

    @staticmethod
    def of(trace: Trace) -> "TraceStats":
        p = trace.prices
        spd = trace.slots_per_day
        t = np.arange(len(p)) % spd
        day = (t >= spd // 4) & (t < 3 * spd // 4)
        a = trace.avail.astype(float)
        night_mean = max(a[~day].mean(), 1e-9) if (~day).any() else 1.0
        return TraceStats(
            price_median=float(np.median(p)),
            price_p90=float(np.percentile(p, 90)),
            median_over_p90=float(np.median(p) / max(np.percentile(p, 90), 1e-9)),
            avail_mean=float(a.mean()),
            avail_day_night_ratio=float(a[day].mean() / night_mean) if day.any() else 1.0,
        )


def _ar1(rng, n, rho, sigma):
    x = np.zeros(n)
    e = rng.normal(0, sigma, n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + e[i]
    return x


def vast_like_trace(
    seed: int = 0,
    days: float = 10.0,
    slots_per_day: int = 48,
    *,
    mean_price: float = 0.45,
    price_sigma: float = 0.32,       # lognormal spread -> median/P90 ~ 0.6
    price_season_amp: float = 0.12,
    avail_mean: float = 8.0,
    avail_season_amp: float = 3.5,
    avail_sigma: float = 2.0,
    avail_max: int = 16,
    price_avail_corr: float = -0.5,
    rho: float = 0.85,
    season_phase_slots: float = 0.0,
) -> Trace:
    """Synthetic 30-min-slot A100 spot market calibrated to paper Fig. 2.

    ``season_phase_slots`` delays the diurnal cycle by that many slots —
    a region ``h`` hours west of the reference has its midday (availability
    peak) ``h * slots_per_day / 24`` slots later. 0.0 keeps the original
    trace bit-for-bit.
    """
    rng = np.random.default_rng(seed)
    n = int(days * slots_per_day)
    tod = (
        2 * np.pi
        * ((np.arange(n) - season_phase_slots) % slots_per_day)
        / slots_per_day
    )

    # shared diurnal demand driver: prices high / availability low at night
    # (paper Fig. 2: "higher availability during the daytime than at night")
    season = np.cos(tod)  # +1 midnight .. -1 midday
    z_price = _ar1(rng, n, rho, price_sigma * np.sqrt(1 - rho**2))
    prices = mean_price * np.exp(
        price_season_amp * season + z_price - 0.5 * price_sigma**2
    )
    prices = np.clip(prices, 0.02, 1.5)

    z_av = _ar1(rng, n, rho, avail_sigma * np.sqrt(1 - rho**2))
    corr_term = price_avail_corr * (z_price / max(price_sigma, 1e-9)) * avail_sigma
    avail = avail_mean - avail_season_amp * season + z_av * np.sqrt(1 - price_avail_corr**2) + corr_term
    avail = np.clip(np.round(avail), 0, avail_max).astype(np.int64)

    return Trace(
        prices=prices.astype(np.float64),
        avail=avail,
        slot_seconds=86400.0 / slots_per_day,
        slots_per_day=slots_per_day,
        meta={"seed": seed, "days": days, "kind": "vast_like",
              "season_phase_slots": season_phase_slots},
    )


def constant_trace(price: float, avail: int, length: int) -> Trace:
    return Trace(
        np.full(length, price), np.full(length, avail, np.int64),
        meta={"kind": "constant"},
    )


def from_arrays(prices, avail, **meta) -> Trace:
    return Trace(
        np.asarray(prices, np.float64),
        np.asarray(avail, np.int64),
        meta=dict(meta, kind="explicit"),
    )
