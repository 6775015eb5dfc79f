"""Synthetic data: the vectorized multi-regime market generator behind the
scenario grid (:func:`market_regime_batch`), its seeded fault-storm variant
(:func:`market_regime_fault_batch`), and the token streams that LoRA
fine-tuning trains on (:class:`MarkovLM`, :func:`token_stream`,
:func:`lm_batches`).

Port of the JAX package's ``data/synthetic.py`` (numpy, copied: the same
seed gives the same bits).
"""
from __future__ import annotations

from typing import Iterator, Optional

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


class MarkovLM:
    """Order-1 Markov chain over the vocab with a few latent 'topics'."""

    def __init__(self, vocab_size: int, seed: int = 0, n_topics: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.n_topics = n_topics
        # sparse-ish transition structure: each token has ~16 likely successors
        self.succ = rng.integers(0, vocab_size, size=(n_topics, vocab_size, 16))
        self.topic_stick = 0.995

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int64)
        tok = int(rng.integers(self.vocab))
        topic = int(rng.integers(self.n_topics))
        for i in range(length):
            out[i] = tok
            if rng.random() > self.topic_stick:
                topic = int(rng.integers(self.n_topics))
            if rng.random() < 0.9:
                tok = int(self.succ[topic, tok, rng.integers(16)])
            else:
                tok = int(rng.integers(self.vocab))
        return out


def token_stream(
    vocab_size: int, seq_len: int, seed: int = 0, doc_len: int = 512
) -> Iterator[np.ndarray]:
    """Infinite stream of (seq_len,) int32 sequences (packed docs)."""
    src = MarkovLM(vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    buf = np.empty(0, np.int64)
    while True:
        while len(buf) < seq_len:
            buf = np.concatenate([buf, src.sample(rng, doc_len)])
        yield buf[:seq_len].astype(np.int32)
        buf = buf[seq_len:]


def lm_batches(
    vocab_size: int,
    global_batch: int,
    seq_len: int,
    seed: int = 0,
    num_batches: Optional[int] = None,
) -> Iterator[dict]:
    """Batches {'tokens': (B, S) int32} for next-token training."""
    stream = token_stream(vocab_size, seq_len, seed)
    i = 0
    while num_batches is None or i < num_batches:
        yield {"tokens": np.stack([next(stream) for _ in range(global_batch)])}
        i += 1
