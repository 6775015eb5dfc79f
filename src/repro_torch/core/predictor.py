"""Spot price/availability forecasting: the numpy half of the JAX package's
``core/predictor.py`` (paper Sec. II-C), copied so the port never loads
JAX. Bit-equal to the reference on the same seeds (pinned in
tests/test_torch_host.py).

Every predictor produces a *prediction matrix* P[t, j, c]: the forecast made
at slot t for slot t+j (j=0 is the observed present, always exact), with
channels c=0 price, c=1 availability.

  PerfectPredictor  — oracle (paper's 'Perfect-Predictor' strategy)
  NoisyPredictor    — the paper's four noise regimes: {magnitude-dependent,
                      fixed-magnitude} x {uniform, heavy-tail}, with error
                      growing in the prediction step j
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.market import Trace, require_finite

NOISE_KINDS = (
    "magdep_uniform",
    "fixed_uniform",
    "magdep_heavytail",
    "fixed_heavytail",
)


def _true_future(trace: Trace, horizon: int) -> np.ndarray:
    """(T, horizon+1, 2) true values, edge-padded past the end."""
    T = len(trace)
    prices = np.concatenate([trace.prices, np.full(horizon, trace.prices[-1])])
    avail = np.concatenate([trace.avail, np.full(horizon, trace.avail[-1])])
    out = np.empty((T, horizon + 1, 2))
    for j in range(horizon + 1):
        out[:, j, 0] = prices[j : j + T]
        out[:, j, 1] = avail[j : j + T]
    return out


def true_future_batch(prices: np.ndarray, avail: np.ndarray,
                      horizon: int) -> np.ndarray:
    """Batched :func:`_true_future`: (K, T) price/avail windows ->
    (K, T, horizon+1, 2) true values, each row edge-padded past its end."""
    prices = np.asarray(prices, float)
    avail = np.asarray(avail, float)
    T = prices.shape[1]
    p = np.concatenate([prices, np.repeat(prices[:, -1:], horizon, axis=1)], 1)
    a = np.concatenate([avail, np.repeat(avail[:, -1:], horizon, axis=1)], 1)
    idx = np.arange(T)[:, None] + np.arange(horizon + 1)[None, :]
    return np.stack([p[:, idx], a[:, idx]], axis=-1)


def noisy_matrix_batch(prices: np.ndarray, avail: np.ndarray, kind: str,
                       level, seeds, horizon: int,
                       avail_max: int = 16) -> np.ndarray:
    """Batched :class:`NoisyPredictor`: the whole (K, T, horizon+1, 2)
    forecast stack in one vectorized pass over (K, T) market windows.

    Bitwise-equal to stacking
    ``NoisyPredictor(window_k, kind, level, seed=seeds[k]).matrix(horizon)``
    over k (pinned in the JAX package's tests): every arithmetic op
    is elementwise over the batch axis, and each row's noise is drawn from
    ``np.random.default_rng(seeds[k])`` exactly as the per-job constructor
    would — the per-seed draw is the one per-row op left (independent
    streams have no batch API); everything around it is vectorized, which
    is what collapses Fig. 9's per-job predictor loop into array code.

    ``level`` may be a scalar (one noise level for every row) or a (K,)
    array of per-row levels — how the scenario grid realizes its
    prediction-noise axis inside one batched call; row k then matches the
    per-job construction at ``level[k]`` (level 0 rows reduce to the
    perfect forecast)."""
    assert kind in NOISE_KINDS, kind
    prices = np.asarray(prices, float)
    avail = np.asarray(avail, float)
    require_finite("prices", prices)
    require_finite("avail", avail)
    require_finite("level", np.asarray(level, float))
    seeds = np.asarray(seeds)
    out = true_future_batch(prices, avail, horizon)
    K = out.shape[0]
    assert seeds.shape == (K,), (seeds.shape, K)
    level = np.asarray(level, float)
    if level.ndim == 0:
        scale = level * np.sqrt(np.arange(horizon + 1))          # 0 at j=0
    else:
        assert level.shape == (K,), (level.shape, K)
        scale = level[:, None] * np.sqrt(np.arange(horizon + 1))  # (K, h+1)
    ref = np.stack([
        np.broadcast_to(prices.mean(axis=1)[:, None], prices.shape),
        np.broadcast_to(avail.mean(axis=1)[:, None], avail.shape),
    ], axis=-1)  # (K, T, 2) per-row reference magnitudes
    shape = out.shape[1:]
    if kind.endswith("uniform"):
        eps = np.stack([
            np.random.default_rng(int(s)).uniform(-1, 1, shape) for s in seeds
        ])
    else:  # heavy-tail: Student-t(3), clipped for sanity
        eps = np.stack([
            np.clip(np.random.default_rng(int(s)).standard_t(3, shape), -8, 8)
            for s in seeds
        ]) / np.sqrt(3)
    if scale.ndim == 1:
        eps = eps * scale[None, None, :, None]
    else:
        eps = eps * scale[:, None, :, None]
    if kind.startswith("magdep"):
        noisy = out * (1.0 + eps)
    else:
        noisy = out + eps * ref[:, :, None, :]
    noisy[..., 0] = np.clip(noisy[..., 0], 0.01, 10.0)
    noisy[..., 1] = np.clip(np.round(noisy[..., 1]), 0, avail_max)
    noisy[:, :, 0, :] = out[:, :, 0, :]  # the present is observed
    return noisy


class PerfectPredictor:
    def __init__(self, trace: Trace):
        self.trace = trace

    def matrix(self, horizon: int) -> np.ndarray:
        return _true_future(self.trace, horizon)


class NoisyPredictor:
    """Perfect forecast corrupted by one of the four paper noise regimes.

    ``level`` is the relative error scale (e.g. 0.1 = 10%); the j-step error
    scales with sqrt(j) (error accumulation in multi-step forecasts).
    """

    def __init__(self, trace: Trace, kind: str, level: float, seed: int = 0,
                 avail_max: int = 16):
        assert kind in NOISE_KINDS, kind
        self.trace, self.kind, self.level, self.seed = trace, kind, level, seed
        self.avail_max = avail_max

    def matrix(self, horizon: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        out = _true_future(self.trace, horizon)
        T = out.shape[0]
        scale = self.level * np.sqrt(np.arange(horizon + 1))  # 0 at j=0
        ref = np.stack([
            np.full(T, np.mean(self.trace.prices)),
            np.full(T, np.mean(self.trace.avail)),
        ], axis=-1)  # (T,2) reference magnitudes for fixed-magnitude noise
        if self.kind.endswith("uniform"):
            eps = rng.uniform(-1, 1, out.shape)
        else:  # heavy-tail: Student-t(3), clipped for sanity
            eps = np.clip(rng.standard_t(3, out.shape), -8, 8) / np.sqrt(3)
        eps = eps * scale[None, :, None]
        if self.kind.startswith("magdep"):
            noisy = out * (1.0 + eps)
        else:
            noisy = out + eps * ref[:, None, :]
        noisy[..., 0] = np.clip(noisy[..., 0], 0.01, 10.0)
        noisy[..., 1] = np.clip(np.round(noisy[..., 1]), 0, self.avail_max)
        noisy[:, 0, :] = out[:, 0, :]  # the present is observed, not predicted
        return noisy
