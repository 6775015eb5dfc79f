"""Spot price/availability forecasting (paper Sec. II-C): the numpy half of
the JAX package's ``core/predictor.py``, copied so the port never loads
JAX, and bit-equal to it on the same seeds (pinned in
tests/test_torch_host.py and tests/test_torch_policies.py); plus a
device-side forecast stack drawn on the card, each row from a
counter-based stream keyed by its seed.

Every predictor produces a *prediction matrix* P[t, j, c]: the forecast made
at slot t for slot t+j (j=0 is the observed present, always exact), with
channels c=0 price, c=1 availability.

  PerfectPredictor  — oracle (paper's 'Perfect-Predictor' strategy)
  NoisyPredictor    — the paper's four noise regimes: {magnitude-dependent,
                      fixed-magnitude} x {uniform, heavy-tail}, with error
                      growing in the prediction step j
  ARIMAPredictor    — seasonally-differenced AR(p) fit by least squares on a
                      rolling history window (the paper's ARIMA with 30-min
                      slots), forecast recursively
  RegionalPredictor — one base predictor per region of a RegionalMarket

``noisy_matrix_batch`` / ``regional_noisy_matrix`` build whole (job x
region) forecast stacks on the host; ``noisy_matrix_batch_torch`` /
``regional_noisy_matrix_torch`` are their device twins (the engine's
``prep_backend="torch"``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

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


def regional_noisy_matrix(prices: np.ndarray, avail: np.ndarray, kind: str,
                          level, seeds, horizon: int,
                          avail_max: int = 16) -> np.ndarray:
    """:func:`noisy_matrix_batch` over (job, region) rows: (K, R, T) market
    windows and (K, R) seeds -> the (K, R, T, horizon+1, 2) stack, in ONE
    batched pass over the flattened (K*R,) row axis. ``level`` is a scalar
    or a (K,) per-job array (shared by that job's regions). Row (k, r)
    equals ``NoisyPredictor(window_kr, kind, level, seed=seeds[k, r])``."""
    prices = np.asarray(prices, float)
    k, r, t = prices.shape
    seeds = np.asarray(seeds)
    assert seeds.shape == (k, r), (seeds.shape, (k, r))
    level = np.asarray(level, float)
    lv = np.repeat(level, r) if level.ndim else level
    out = noisy_matrix_batch(prices.reshape(k * r, t),
                             np.asarray(avail).reshape(k * r, t), kind, lv,
                             seeds.reshape(-1), horizon, avail_max)
    return out.reshape(k, r, t, horizon + 1, 2)


_MASK32 = 0xFFFFFFFF


def _pcg(x: torch.Tensor) -> torch.Tensor:
    """The PCG hash (Jarzynski and Olano, JCGT 2020) of 32-bit words held
    in int64: every product stays below 2**62, so no step overflows and
    the bits are the same on every device."""
    s = (x * 747796405 + 2891336453) & _MASK32
    w = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & _MASK32
    return (w >> 22) ^ w


def _row_uniforms(seeds, n: int, dev, open_below: bool = False):
    """(K, n) f32 uniforms on [0, 1) (or (0, 1] with ``open_below``) on
    ``dev``: element i of row k is a hash of (seeds[k], i) alone, a
    counter-based stream as a per-row PRNG key is, so a row's draws do not
    depend on which rows share the batch. The whole batch is a few
    elementwise ops: no host loop over rows."""
    s = np.asarray(seeds).astype(np.uint64)
    lo = torch.as_tensor((s & np.uint64(_MASK32)).astype(np.int64),
                         device=dev)
    hi = torch.as_tensor((s >> np.uint64(32)).astype(np.int64), device=dev)
    key = _pcg(_pcg(hi) ^ lo)
    ctr = _pcg(torch.arange(n, dtype=torch.int64, device=dev))
    bits = _pcg(ctr[None, :] ^ key[:, None]) >> 8            # 24 bits
    return (bits + int(open_below)).to(torch.float32) * 2.0 ** -24


def _noise(kind: str, seeds, shape, dev) -> torch.Tensor:
    """(K,) + ``shape`` f32 noise on ``dev``, row k keyed by ``seeds[k]``
    (:func:`_row_uniforms`): uniform on [-1, 1), or Student-t(3) — a
    normal over the root of a chi-square(3) / 3 made of three squared
    normals, the four normals by Box-Muller — clipped to [-8, 8], over
    sqrt(3)."""
    m = int(np.prod(shape))
    k = len(seeds)
    if kind.endswith("uniform"):
        u = _row_uniforms(seeds, m, dev)
        return (u * 2.0 - 1.0).reshape((k,) + tuple(shape))
    u = _row_uniforms(seeds, 4 * m, dev, open_below=True).reshape(k, 2, 2, m)
    r = torch.sqrt(-2.0 * torch.log(u[:, :, 0]))             # (K, 2, m)
    ang = (2.0 * np.pi) * u[:, :, 1]
    z = torch.cat([r * torch.cos(ang), r * torch.sin(ang)], dim=1)
    chi = (z[:, 1:] * z[:, 1:]).sum(dim=1)
    t = z[:, 0] / torch.sqrt(chi / 3.0)
    t = torch.clamp(t, -8.0, 8.0) / float(np.float32(np.sqrt(3.0)))
    return t.reshape((k,) + tuple(shape))


def noisy_matrix_batch_torch(prices, avail, kind: str, level, seeds,
                             horizon: int, avail_max: int = 16,
                             device=None) -> torch.Tensor:
    """Device twin of :func:`noisy_matrix_batch`: the (K, T, horizon+1, 2)
    noisy forecast stack built on ``device`` (None: the card) in f32, born
    where the pool simulator reads it.

    Same math as the numpy stack (sqrt(j) error growth, per-row reference
    magnitudes, clips, the observed present restored), but row k's noise is
    a counter-based stream keyed by ``seeds[k]`` (:func:`_row_uniforms`),
    drawn for every row at once on the device: each row's draws depend on
    its seed alone, as the numpy rows' do, but they are not numpy's bits.
    So this stack matches the numpy oracle on decisions (the selected
    winner, the regret ratio), not bit for bit; at level 0 it is exactly
    the true future."""
    assert kind in NOISE_KINDS, kind
    dev = resolve_device(device)
    # per-row reference magnitudes in f64 on the host, as the numpy stack
    # takes them: a row's value does not hang on a device reduction's order
    ref = np.stack([np.asarray(prices, np.float64).mean(axis=1),
                    np.asarray(avail, np.float64).mean(axis=1)],
                   axis=-1).astype(np.float32)
    prices = torch.as_tensor(np.asarray(prices, np.float32), device=dev)
    avail = torch.as_tensor(np.asarray(avail, np.float32), device=dev)
    seeds = np.asarray(seeds)
    k, t = prices.shape
    assert seeds.shape == (k,), (seeds.shape, k)
    idx = (torch.arange(t, device=dev)[:, None]
           + torch.arange(horizon + 1, device=dev)[None, :])
    pad = lambda x: torch.cat([x, x[:, -1:].expand(k, horizon)], dim=1)
    out = torch.stack([pad(prices)[:, idx], pad(avail)[:, idx]], dim=-1)
    steps = torch.sqrt(torch.arange(horizon + 1, dtype=torch.float32,
                                    device=dev))
    level = torch.as_tensor(np.asarray(level, np.float32), device=dev)
    scale = level * steps if level.ndim == 0 else level[:, None] * steps
    eps = _noise(kind, seeds, out.shape[1:], dev)
    eps = eps * (scale[None, None, :, None] if scale.ndim == 1
                 else scale[:, None, :, None])
    if kind.startswith("magdep"):
        noisy = out * (1.0 + eps)
    else:
        ref = torch.as_tensor(ref, device=dev)
        noisy = out + eps * ref[:, None, None, :]
    noisy = torch.stack([
        torch.clamp(noisy[..., 0], 0.01, 10.0),
        torch.clamp(torch.round(noisy[..., 1]), 0.0, float(avail_max)),
    ], dim=-1)
    noisy[:, :, 0, :] = out[:, :, 0, :]  # the present is observed
    return noisy


def regional_noisy_matrix_torch(prices, avail, kind: str, level, seeds,
                                horizon: int, avail_max: int = 16,
                                device=None) -> torch.Tensor:
    """:func:`regional_noisy_matrix` on the device: (K, R, T) windows and
    (K, R) seeds -> the (K, R, T, horizon+1, 2) stack from ONE
    :func:`noisy_matrix_batch_torch` call over the flattened rows."""
    prices = np.asarray(prices, np.float32)
    k, r, t = prices.shape
    seeds = np.asarray(seeds)
    assert seeds.shape == (k, r), (seeds.shape, (k, r))
    level = np.asarray(level, np.float32)
    lv = np.repeat(level, r) if level.ndim else level
    out = noisy_matrix_batch_torch(
        prices.reshape(k * r, t), np.asarray(avail).reshape(k * r, t), kind,
        lv, seeds.reshape(-1), horizon, avail_max, device=device)
    return out.reshape(k, r, t, horizon + 1, 2)


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


@dataclass
class ARIMAConfig:
    p: int = 2                 # AR order on deseasonalized residuals
    seasonal_lag: int = 48     # one day of 30-min slots
    history: int = 10 * 48     # fit window
    ridge: float = 1e-3


class ARIMAPredictor:
    """Seasonal AR: y_t = m_{t mod s} + r_t with AR(p) residuals.

    The seasonal profile m (per time-of-day mean over the history window)
    captures the diurnal cycle; the residual AR(p) (numpy lstsq with ridge)
    captures the persistent noise — a SARIMA-family decomposition that beats
    both pure persistence and naive seasonal differencing on AR-dominated
    diurnal traces (test_market_predictor.py pins this).
    """

    def __init__(self, trace: Trace, cfg: Optional[ARIMAConfig] = None,
                 avail_max: int = 16):
        self.trace = trace
        self.cfg = cfg or ARIMAConfig(seasonal_lag=trace.slots_per_day)
        self.avail_max = avail_max

    def _fit_forecast(self, series: np.ndarray, t: int, horizon: int) -> np.ndarray:
        c = self.cfg
        s, p = c.seasonal_lag, c.p
        start = max(0, t + 1 - c.history)
        hist = series[start : t + 1]
        if len(hist) < s + p + 8:  # not enough data: persistence forecast
            return np.full(horizon, series[t])
        logspace = bool(np.all(hist > 0))  # prices: multiplicative dynamics
        h = np.log(hist) if logspace else hist.astype(float)
        # smoothed seasonal profile over the history window
        idx = (np.arange(start, t + 1)) % s
        prof = np.full(s, h.mean())
        for k in range(s):
            sel = h[idx == k]
            if len(sel):
                prof[k] = sel.mean()
        w = 5  # circular smoothing kills per-slot profile noise
        ker = np.ones(w) / w
        prof = np.convolve(np.concatenate([prof[-w:], prof, prof[:w]]), ker, "same")[w:-w]
        r = h - prof[idx]
        # AR(p) on deseasonalized residuals
        X = np.stack([r[p - i - 1 : len(r) - i - 1] for i in range(p)], axis=1)
        y = r[p:]
        A = X.T @ X + c.ridge * len(y) * np.eye(p)
        coef = np.linalg.solve(A, X.T @ y)
        rbuf = list(r[-p:])  # oldest..newest
        out = np.empty(horizon)
        for j in range(1, horizon + 1):
            rn = float(np.dot(coef, rbuf[::-1][:p]))
            v = prof[(t + j) % s] + rn
            out[j - 1] = np.exp(v) if logspace else v
            rbuf.append(rn)
        return out

    def matrix(self, horizon: int) -> np.ndarray:
        T = len(self.trace)
        out = _true_future(self.trace, horizon)  # j=0 column = observed
        for t in range(T):
            fp = self._fit_forecast(self.trace.prices, t, horizon)
            fa = self._fit_forecast(self.trace.avail.astype(float), t, horizon)
            out[t, 1:, 0] = np.clip(fp, 0.01, 10.0)
            out[t, 1:, 1] = np.clip(np.round(fa), 0, self.avail_max)
        return out


class RegionalPredictor:
    """Per-region predictor lifted to a multi-region market: ``matrix``
    returns (R, T, horizon+1, 2) — one prediction matrix per region, each
    produced by an independent base predictor.

    ``factory(trace, region_index) -> predictor`` builds the per-region base
    (default: PerfectPredictor). The region index lets noisy/ARIMA factories
    decorrelate seeds across regions, e.g.::

        RegionalPredictor(market,
                          lambda tr, r: NoisyPredictor(tr, "fixed_uniform",
                                                       0.2, seed=r))
    """

    def __init__(self, market, factory=None):
        self.market = market
        self.factory = factory or (lambda tr, r: PerfectPredictor(tr))
        self.predictors = [
            self.factory(market.region(r), r) for r in range(market.n_regions)
        ]

    def matrix(self, horizon: int) -> np.ndarray:
        return np.stack([p.matrix(horizon) for p in self.predictors])


def mape(pred: np.ndarray, true: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - true) / np.maximum(np.abs(true), 1e-6)))


def forecast_errors(trace: Trace, predictor, horizon: int) -> dict:
    """Per-step MAPE for price and availability (benchmarks/fig3)."""
    M = predictor.matrix(horizon)
    truth = _true_future(trace, horizon)
    out = {"price": [], "avail": []}
    T = len(trace)
    for j in range(1, horizon + 1):
        valid = np.arange(T - j)
        out["price"].append(mape(M[valid, j, 0], truth[valid, j, 0]))
        out["avail"].append(mape(M[valid, j, 1], np.maximum(truth[valid, j, 1], 1)))
    return out
