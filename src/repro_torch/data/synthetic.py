"""Synthetic market regimes: the vectorized multi-regime market generator
behind the scenario grid (:func:`market_regime_batch`) and its seeded
fault-storm variant (:func:`market_regime_fault_batch`).

Port of the regime half of the JAX package's ``data/synthetic.py`` (numpy,
copied). The token-stream half (``MarkovLM``, ``token_stream``,
``lm_batches``) belongs to the training slice and is not ported yet.
"""
from __future__ import annotations

import numpy as np


def _ar1_rows(e: np.ndarray, rho: float) -> np.ndarray:
    """Row-batched AR(1): x[:, i] = rho * x[:, i-1] + e[:, i], x[:, 0] = 0.
    Elementwise over the regime axis, so each row is bitwise-equal to
    ``market._ar1`` fed the same innovations."""
    x = np.zeros_like(e)
    for i in range(1, e.shape[1]):
        x[:, i] = rho * x[:, i - 1] + e[:, i]
    return x


def market_regime_batch(
    seeds,
    days: float = 10.0,
    slots_per_day: int = 48,
    *,
    mean_price=0.45,
    price_sigma=0.32,
    price_season_amp: float = 0.12,
    avail_mean=8.0,
    avail_season_amp=3.5,
    avail_sigma=2.0,
    avail_max: int = 16,
    price_avail_corr: float = -0.5,
    rho: float = 0.85,
    season_phase_slots: float = 0.0,
):
    """Vectorized multi-regime :func:`repro_torch.core.market.vast_like_trace`.

    ``seeds`` is (R,); ``mean_price`` / ``price_sigma`` / ``avail_mean`` /
    ``avail_season_amp`` / ``avail_sigma`` broadcast to (R,) — one market
    regime per row. Returns ``(prices (R, T) f64, avail (R, T) i64)``.

    Row r is bitwise-equal to ``vast_like_trace(seed=seeds[r], ...)`` with
    that row's parameters (the reference pins this; the port's copy is held
    bit-equal to the reference's in tests/test_torch_chaos.py): the
    per-seed ``np.random.default_rng`` draws are issued in exactly the
    scalar constructor's order (price innovations first, then availability)
    — the one per-row loop left, like predictor.noisy_matrix_batch — and
    every transform around them is elementwise over the regime axis,
    including the AR(1) recursion (row-batched in :func:`_ar1_rows`).
    Because each row depends only on its own (seed, params), a regime's
    market is invariant to the grid composition around it.
    """
    seeds = np.asarray(seeds)
    R = seeds.shape[0]
    n = int(days * slots_per_day)
    mp = np.broadcast_to(np.asarray(mean_price, float), (R,))
    ps = np.broadcast_to(np.asarray(price_sigma, float), (R,))
    am = np.broadcast_to(np.asarray(avail_mean, float), (R,))
    aa = np.broadcast_to(np.asarray(avail_season_amp, float), (R,))
    av_sig = np.broadcast_to(np.asarray(avail_sigma, float), (R,))

    tod = (
        2 * np.pi
        * ((np.arange(n) - season_phase_slots) % slots_per_day)
        / slots_per_day
    )
    season = np.cos(tod)

    e_p = np.empty((R, n))
    e_a = np.empty((R, n))
    for r in range(R):
        rng = np.random.default_rng(int(seeds[r]))
        e_p[r] = rng.normal(0, ps[r] * np.sqrt(1 - rho**2), n)
        e_a[r] = rng.normal(0, av_sig[r] * np.sqrt(1 - rho**2), n)

    z_price = _ar1_rows(e_p, rho)
    prices = mp[:, None] * np.exp(
        price_season_amp * season[None, :] + z_price - 0.5 * ps[:, None] ** 2
    )
    prices = np.clip(prices, 0.02, 1.5)

    z_av = _ar1_rows(e_a, rho)
    corr_term = (
        price_avail_corr
        * (z_price / np.maximum(ps, 1e-9)[:, None])
        * av_sig[:, None]
    )
    avail = (
        am[:, None]
        - aa[:, None] * season[None, :]
        + z_av * np.sqrt(1 - price_avail_corr**2)
        + corr_term
    )
    avail = np.clip(np.round(avail), 0, avail_max).astype(np.int64)
    return prices.astype(np.float64), avail


def market_regime_fault_batch(
    seeds,
    fault_seeds,
    days: float = 10.0,
    slots_per_day: int = 48,
    *,
    n_storms=2,
    storm_len: int = 4,
    spike_mag: float = 1.0,
    pred_fault="stale",
    **regime_kw,
):
    """:func:`market_regime_batch` with a per-row seeded preemption-storm
    schedule on top — faults become one more scenario-grid axis.

    ``fault_seeds`` is (R,) like ``seeds``; ``n_storms`` broadcasts to
    (R,) so a grid can sweep fault *intensity* across rows (0 storms = the
    clean regime, bitwise-equal to :func:`market_regime_batch`). Returns
    ``(prices (R, T), avail (R, T), schedules)`` where ``schedules`` is
    the R-tuple of per-row ``FaultSpec`` tuples — feed each row's schedule
    to :func:`repro_torch.chaos.inject` to fault that row's forecast stack the
    same way.
    """
    from repro_torch.chaos import inject_market, storm_schedule

    prices, avail = market_regime_batch(
        seeds, days, slots_per_day, **regime_kw)
    fault_seeds = np.asarray(fault_seeds)
    R, T = prices.shape
    if fault_seeds.shape != (R,):
        raise ValueError(
            f"fault_seeds must be shape ({R},), got {fault_seeds.shape}")
    ns = np.broadcast_to(np.asarray(n_storms, int), (R,))
    schedules = tuple(
        storm_schedule(int(fault_seeds[r]), T, n_storms=int(ns[r]),
                       storm_len=storm_len, spike_mag=spike_mag,
                       pred_fault=pred_fault)
        for r in range(R)
    )
    for r, sched in enumerate(schedules):
        if sched:
            prices[r], avail[r] = inject_market(prices[r], avail[r], sched)
    return prices, avail, schedules
