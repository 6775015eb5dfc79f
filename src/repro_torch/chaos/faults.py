"""Structured, seeded fault injection over market traces and forecasts.

Port of the JAX package's ``chaos/faults.py`` (numpy, copied whole). The
chaos layer is a set of PURE batched transforms applied on the host,
before the data reaches the engines — the engines never learn a
fault happened, which is the point: market faults (preemption storms,
regional blackouts, price spikes) mutate what the market actually *does*,
while the forecast stack keeps saying what the predictor *believed* —
except for its observed-present column (``pred[..., 0, :]``), which
:func:`inject` re-syncs to the faulted market because the present slot is
always observed, never predicted. Predictor faults (``pred_outage`` /
``pred_stale``) instead corrupt the forecast rows ``j >= 1`` directly and
leave the market alone.

Every transform is shape-agnostic over the trailing time axis — ``(T,)``
single traces, ``(K, T)`` per-job window batches
(``engine.prepare_noisy_inputs`` output, ``data.synthetic.
market_regime_batch`` rows), and ``(..., R, T)`` regional tensors for
blackouts — and is the identity outside its window; an empty schedule is
a bitwise no-op (the reference pins this with hypothesis properties,
along with avail >= 0 / prices >= 0 invariants; tests/test_torch_chaos.py
holds the copy bit-equal to it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

# market faults hit (prices, avail); forecast faults hit the pred stack
MARKET_KINDS = ("preempt_storm", "blackout", "price_spike")
FORECAST_KINDS = ("pred_outage", "pred_stale")
FAULT_KINDS = MARKET_KINDS + FORECAST_KINDS


@dataclass(frozen=True)
class FaultSpec:
    """One fault window.

    ``kind``       one of :data:`FAULT_KINDS`:

                   - ``preempt_storm`` — availability forced to 0
                   - ``blackout`` — availability forced to 0 in region
                     ``region`` (axis -2 of a regional tensor; ``region <
                     0`` blacks out every region, same as a storm)
                   - ``price_spike`` — prices multiplied by ``magnitude``
                   - ``pred_outage`` — forecast rows ``j >= 1`` zeroed
                     (the predictor went dark; the observed present stays)
                   - ``pred_stale`` — forecast rows ``j >= 1`` frozen at
                     the last pre-window forecast matrix (the predictor
                     stopped refreshing)

    ``start``      first faulted slot (absolute index on the time axis)
    ``length``     window length in slots (clipped at the trace end)
    ``magnitude``  price multiplier for ``price_spike`` (ignored otherwise)
    ``region``     region index for ``blackout`` (ignored otherwise)
    """
    kind: str
    start: int
    length: int
    magnitude: float = 1.0
    region: int = -1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.start < 0 or self.length < 0:
            raise ValueError(
                f"fault window start/length must be >= 0, got "
                f"start={self.start} length={self.length}")
        if self.magnitude < 0:
            raise ValueError(f"magnitude must be >= 0, got {self.magnitude}")


def window_mask(n_slots: int, spec: FaultSpec) -> np.ndarray:
    """(T,) bool mask of the slots inside ``spec``'s window."""
    idx = np.arange(n_slots)
    return (idx >= spec.start) & (idx < spec.start + spec.length)


def inject_market(prices, avail, faults: Sequence[FaultSpec]):
    """Apply the market faults in ``faults`` (others are skipped) to
    ``prices``/``avail`` with a shared trailing time axis. Returns new
    arrays (inputs untouched); dtypes are preserved, so integer
    availability stays integer."""
    prices = np.array(prices, copy=True)
    avail = np.array(avail, copy=True)
    if prices.shape[-1] != avail.shape[-1]:
        raise ValueError(
            f"prices/avail time axes disagree: {prices.shape} vs {avail.shape}")
    n_slots = prices.shape[-1]
    for f in faults:
        if f.kind not in MARKET_KINDS:
            continue
        m = window_mask(n_slots, f)
        if not m.any():
            continue
        if f.kind == "price_spike":
            prices[..., m] = (prices[..., m] * f.magnitude).astype(
                prices.dtype, copy=False)
        elif f.kind == "preempt_storm" or f.region < 0:
            avail[..., m] = 0
        else:  # regional blackout
            if avail.ndim < 2:
                raise ValueError(
                    "blackout with region >= 0 needs a (..., R, T) "
                    f"availability tensor, got shape {avail.shape}")
            avail[..., f.region, m] = 0
    return prices, avail


def inject_forecasts(preds, faults: Sequence[FaultSpec]):
    """Apply the predictor faults in ``faults`` (others are skipped) to a
    ``(..., T, h+1, 2)`` forecast stack. Only the future rows ``j >= 1``
    are touched — row 0 is the observed present, which no predictor outage
    can take away. Returns a new array."""
    preds = np.array(preds, copy=True)
    if preds.ndim < 3:
        raise ValueError(
            f"forecast stack must be (..., T, h+1, 2), got shape {preds.shape}")
    n_slots, h1 = preds.shape[-3], preds.shape[-2]
    future = np.arange(h1) >= 1                      # (h+1,)
    for f in faults:
        if f.kind not in FORECAST_KINDS:
            continue
        m = window_mask(n_slots, f)
        if not m.any():
            continue
        sel = (m[:, None] & future[None, :])[..., None]  # (T, h+1, 1)
        if f.kind == "pred_outage":
            repl = np.zeros((), preds.dtype)
        else:  # pred_stale: replay the last matrix issued before the window
            t_freeze = max(min(f.start, n_slots) - 1, 0)
            repl = preds[..., t_freeze, None, :, :]       # (..., 1, h+1, 2)
        preds = np.where(sel, repl, preds).astype(preds.dtype, copy=False)
    return preds


def sync_present(preds, prices, avail):
    """Re-sync the observed-present column of a forecast stack to a
    (possibly faulted) market: ``pred[..., 0, 0] = prices``,
    ``pred[..., 0, 1] = avail``. Returns a new array."""
    preds = np.array(preds, copy=True)
    preds[..., 0, 0] = prices
    preds[..., 0, 1] = avail
    return preds


def inject(prices, avail, preds, faults: Sequence[FaultSpec]):
    """The one-call composition: market faults, then the present-column
    re-sync (the present is always observed), then the predictor faults.
    Future forecast rows are NOT re-synced to market faults — that is the
    chaos scenario: the market broke and the predictor did not see it
    coming. ``preds=None`` skips the forecast leg. Returns
    ``(prices, avail, preds)`` as new arrays."""
    p, a = inject_market(prices, avail, faults)
    if preds is None:
        return p, a, None
    return p, a, inject_forecasts(sync_present(preds, p, a), faults)


# ---------------------------------------------------------------------------
# Seeded schedules
# ---------------------------------------------------------------------------

def storm_schedule(seed: int, n_slots: int, *, n_storms: int = 2,
                   storm_len: int = 3, spike_mag: float = 1.0,
                   pred_fault: str = "stale") -> Tuple[FaultSpec, ...]:
    """Seeded preemption-storm schedule: ``n_storms`` bursts, one per
    equal segment of the horizon (so storms never overlap), each forcing
    availability to zero for ``storm_len`` slots. ``spike_mag != 1``
    additionally spikes prices over the same windows; ``pred_fault``
    (``"stale"`` / ``"outage"`` / ``None``) aligns a predictor fault with
    each storm — the forced regime of the chaos bench. Deterministic for a
    given (seed, n_slots, knobs)."""
    if pred_fault not in ("stale", "outage", None):
        raise ValueError(f"pred_fault must be 'stale'/'outage'/None, "
                         f"got {pred_fault!r}")
    rng = np.random.default_rng(seed)
    faults = []
    if n_storms <= 0:
        return ()
    seg = max(n_slots // n_storms, 1)
    for i in range(n_storms):
        lo = min(i * seg, n_slots - 1)
        hi = max(min((i + 1) * seg, n_slots) - storm_len, lo)
        start = int(rng.integers(lo, hi + 1))
        faults.append(FaultSpec("preempt_storm", start, storm_len))
        if spike_mag != 1.0:
            faults.append(
                FaultSpec("price_spike", start, storm_len, magnitude=spike_mag))
        if pred_fault is not None:
            faults.append(FaultSpec(f"pred_{pred_fault}", start, storm_len))
    return tuple(faults)


def blackout_schedule(seed: int, n_slots: int, n_regions: int, *,
                      n_events: int = 1,
                      length: int = 4) -> Tuple[FaultSpec, ...]:
    """Seeded regional-blackout schedule for ``simulate_pool_regions*``
    markets: ``n_events`` windows, each zeroing one seeded region's
    availability for ``length`` slots."""
    rng = np.random.default_rng(seed)
    faults = []
    for _ in range(n_events):
        start = int(rng.integers(0, max(n_slots - length, 0) + 1))
        region = int(rng.integers(0, n_regions))
        faults.append(FaultSpec("blackout", start, length, region=region))
    return tuple(faults)
