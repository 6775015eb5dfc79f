"""Multi-region spot markets (BEYOND-PAPER, SkyNomad arXiv:2601.06520), a
copy of the JAX package's ``core/region_market.py``.

The paper's market model (Fig. 2) is single-region. Real spot markets span
regions whose (price, availability) processes are phase-shifted copies of
the same diurnal demand cycle — when it is night (scarce, pricey spot) in
one region it is midday (plentiful, cheap spot) eight time zones away.
SkyNomad shows that for deadline-bound batch jobs this makes cross-region
migration the dominant cost lever, PROVIDED the mover pays the checkpoint
transfer: here ``delta_mig`` slots during which the job holds zero
instances.

This module provides:

  RegionalMarket       stacked (R, T) price/availability traces + the
                       migration cost, with per-region ``Trace`` views
  vast_like_regions    R phase-shifted ``vast_like_trace`` regions with
                       per-region price levels/volatility
  simulate_regional    the python reference simulator: region selection
                       (policies.RegionSelector) layered over the paper's
                       slot execution — the oracle the vectorized
                       fast_sim.simulate_pool_regions lanes are pinned to

The vectorized path lives in fast_sim.simulate_pool_regions; the pool lanes
that pair a scheduling policy with a region strategy come from
policy_pool.region_pool.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.job import value_fn
from repro_torch.core.market import Trace, TraceStats, vast_like_trace
from repro_torch.core.policies import BasePolicy, Obs, RegionSelector
from repro_torch.core.simulator import SimResult, exec_slot, termination_config


@dataclass
class RegionalMarket:
    prices: np.ndarray          # (R, T) spot price per region
    avail: np.ndarray           # (R, T) int, available spot instances
    slot_seconds: float = 1800.0
    slots_per_day: int = 48
    delta_mig: int = 1          # checkpoint-transfer cost: slots lost per move
    region_names: Sequence[str] = ()
    meta: dict = field(default_factory=dict)
    # per-region on-demand price MULTIPLIERS of a job's flat
    # on_demand_price (regions price reserved capacity differently too).
    # None (the default) or a scalar keeps the flat-od behavior — a scalar
    # broadcasts, and 1.0 multipliers are IEEE-exact no-ops, so old
    # behavior is preserved bitwise; an (R,) vector makes the od leg of
    # billing (and the AHAP thresholds/window solves) region-dependent.
    p_od: Optional[np.ndarray] = None

    def __post_init__(self):
        assert self.prices.shape == self.avail.shape, (
            self.prices.shape, self.avail.shape)
        assert self.prices.ndim == 2, self.prices.shape
        if not self.region_names:
            self.region_names = tuple(
                f"r{i}" for i in range(self.prices.shape[0]))
        if self.p_od is not None:
            self.p_od = np.broadcast_to(
                np.asarray(self.p_od, np.float64).reshape(-1),
                (self.prices.shape[0],),
            )

    def __len__(self):  # number of slots, matching Trace
        return self.prices.shape[1]

    @property
    def n_regions(self) -> int:
        return self.prices.shape[0]

    def region(self, r: int) -> Trace:
        """Single-region Trace view (shares the underlying arrays)."""
        return Trace(
            self.prices[r], self.avail[r], self.slot_seconds,
            self.slots_per_day,
            dict(self.meta, region=self.region_names[r]),
        )

    def window(self, t0: int, length: int) -> "RegionalMarket":
        if t0 < 0 or length < 0 or t0 + length > len(self):
            raise ValueError(
                f"window [{t0}, {t0 + length}) out of bounds for market of "
                f"length {len(self)}"
            )
        return RegionalMarket(
            self.prices[:, t0 : t0 + length], self.avail[:, t0 : t0 + length],
            self.slot_seconds, self.slots_per_day, self.delta_mig,
            self.region_names, dict(self.meta, t0=t0), p_od=self.p_od,
        )

    def stats(self) -> List[TraceStats]:
        return [TraceStats.of(self.region(r)) for r in range(self.n_regions)]

    @staticmethod
    def from_traces(traces: Sequence[Trace], delta_mig: int = 1,
                    region_names: Sequence[str] = (),
                    p_od=None) -> "RegionalMarket":
        t0 = traces[0]
        for i, t in enumerate(traces[1:], 1):  # no silent misalignment:
            if len(t) != len(t0):              # regions share one time base
                raise ValueError(
                    f"trace {i} has {len(t)} slots, trace 0 has {len(t0)}"
                )
            if (t.slot_seconds, t.slots_per_day) != (
                    t0.slot_seconds, t0.slots_per_day):
                raise ValueError(
                    f"trace {i} slot base ({t.slot_seconds}s, "
                    f"{t.slots_per_day}/day) differs from trace 0"
                )
        return RegionalMarket(
            prices=np.stack([np.asarray(t.prices, np.float64)
                             for t in traces]),
            avail=np.stack([np.asarray(t.avail, np.int64)
                            for t in traces]),
            slot_seconds=t0.slot_seconds,
            slots_per_day=t0.slots_per_day,
            delta_mig=delta_mig,
            region_names=tuple(region_names),
            meta={"kind": "from_traces"},
            p_od=p_od,
        )


def vast_like_regions(
    n_regions: int,
    seed: int = 0,
    days: float = 10.0,
    slots_per_day: int = 48,
    *,
    phase_hours: Optional[Sequence[float]] = None,
    mean_prices: Optional[Sequence[float]] = None,
    price_sigmas: Optional[Sequence[float]] = None,
    avail_means: Optional[Sequence[float]] = None,
    delta_mig: int = 1,
    **trace_kwargs,
) -> RegionalMarket:
    """R Vast.ai-like regions sharing one diurnal demand cycle, phase-shifted
    per region's time zone.

    Defaults: phases spread evenly over 24h (region r is ``r * 24/R`` hours
    behind region 0), identical price levels/volatility/availability unless
    overridden per region. Each region gets an independent noise seed;
    remaining ``trace_kwargs`` pass through to ``vast_like_trace``.
    """
    if phase_hours is None:
        phase_hours = [24.0 * r / n_regions for r in range(n_regions)]
    assert len(phase_hours) == n_regions, (phase_hours, n_regions)
    per_region = lambda v, r, default: (
        default if v is None else v[r] if not np.isscalar(v) else v)
    traces = []
    for r in range(n_regions):
        kw = dict(trace_kwargs)
        if mean_prices is not None:
            kw["mean_price"] = per_region(mean_prices, r, None)
        if price_sigmas is not None:
            kw["price_sigma"] = per_region(price_sigmas, r, None)
        if avail_means is not None:
            kw["avail_mean"] = per_region(avail_means, r, None)
        traces.append(vast_like_trace(
            seed=seed * 1009 + r,
            days=days,
            slots_per_day=slots_per_day,
            season_phase_slots=phase_hours[r] * slots_per_day / 24.0,
            **kw,
        ))
    market = RegionalMarket.from_traces(
        traces, delta_mig=delta_mig,
        region_names=[f"r{r}(+{phase_hours[r]:g}h)" for r in range(n_regions)],
    )
    market.meta = {"kind": "vast_like_regions", "seed": seed, "days": days,
                   "phase_hours": tuple(phase_hours)}
    return market


@dataclass
class RegionalSimResult(SimResult):
    region_hist: np.ndarray = None   # (d,) region occupied each slot
    migrations: int = 0              # completed switch decisions


def simulate_regional(
    policy: BasePolicy,
    selector: RegionSelector,
    job: JobConfig,
    tput: ThroughputConfig,
    market: RegionalMarket,
    pred_matrix: Optional[np.ndarray] = None,  # (R, T, horizon+1, 2)
) -> RegionalSimResult:
    """Reference regional simulator: simulator.simulate with a region layer.

    Each slot: score regions (selector), pick/hold a region with hysteresis,
    observe the selected region's (price, avail, forecast), let the
    scheduling policy decide as usual, then — if a checkpoint transfer is in
    flight — override the allocation to zero for that slot (no progress, no
    billing). Everything else (feasibility clip, mu, whole-slot billing,
    fractional completion, termination configuration) is byte-for-byte the
    single-region reference loop, which this reduces to when R == 1 (the
    selector never leaves region 0 and no migration is ever charged).

    Input convention (same as the single-region parity pins): for exact
    agreement with the fast AHAP lanes, ``pred_matrix`` must cover the
    policy's window — pass a predictor horizon >= the largest omega (i.e.
    fast_sim.W1MAX - 1), or the edge-padded matrix from
    ``prepare_inputs_regions``. Region *scores* are horizon-robust either
    way (RegionSelector pads to RSEL_PRED_WINDOW itself); a too-short
    forecast only starves the python AHAP's plan window relative to the
    padded one the fast lanes see.

    When the market carries per-region on-demand multipliers
    (``market.p_od``), each slot runs against an *effective* job whose
    ``on_demand_price`` is scaled by the occupied region's multiplier —
    the policy's decision, the slot billing, and (via the final region)
    the termination configuration all see the regional od price. ``None``
    leaves the loop byte-for-byte as before.
    """
    d = job.deadline
    assert len(market) >= d, "market shorter than deadline"
    policy.reset(job, tput)
    selector.reset(job, market.delta_mig)
    pod = market.p_od
    eff_job = (lambda r: job) if pod is None else (
        lambda r: replace(job, on_demand_price=job.on_demand_price
                          * float(pod[r])))

    z, n_prev, cost = 0.0, 0, 0.0
    T_complete: Optional[float] = None
    ns_hist, no_hist = np.zeros(d, int), np.zeros(d, int)
    region_hist = np.zeros(d, int)
    migrations = 0
    cur = 0

    for t in range(d):
        pred_t = pred_matrix[:, t] if pred_matrix is not None else None
        sc = selector.scores(market.prices[:, t], market.avail[:, t], pred_t)
        cur, migrating, switched = selector.step(sc)
        migrations += int(switched)
        region_hist[t] = cur

        price, avail = float(market.prices[cur, t]), int(market.avail[cur, t])
        pred = pred_t[cur] if pred_t is not None else None
        job_t = eff_job(cur)
        policy.job = job_t  # policies read self.job fresh every decide
        obs = Obs(t=t, price=price, avail=avail, z_prev=z, n_prev=n_prev,
                  pred=pred)
        n_o, n_s = policy.decide(obs)
        if migrating:   # checkpoint in transit: hold nothing this slot
            n_o = n_s = 0
        # slot execution is shared with simulator.simulate — the single-
        # region loop and this one cannot drift apart
        n_o, n_s, work, dc, T_complete = exec_slot(
            job_t, tput, z, n_prev, t, n_o, n_s, price, avail
        )
        cost += dc
        ns_hist[t], no_hist[t] = n_s, n_o
        z = min(z + work, job.workload)
        n_prev = n_o + n_s
        if T_complete is not None:
            break

    if T_complete is not None:
        value = float(value_fn(job, T_complete))
    else:
        # termination configuration: N^max on-demand past the deadline,
        # billed at the final occupied region's od rate
        dt, dc = termination_config(eff_job(cur), tput, z)
        T_complete = d + dt
        cost += dc
        value = float(value_fn(job, T_complete))

    return RegionalSimResult(
        utility=value - cost,
        value=value,
        cost=cost,
        completion_time=float(T_complete),
        z_ddl=float(z),
        completed_by_deadline=T_complete <= d,
        n_total=ns_hist + no_hist,
        n_spot=ns_hist,
        n_od=no_hist,
        region_hist=region_hist,
        migrations=migrations,
    )
