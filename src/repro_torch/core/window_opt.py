"""Exact solver for the CHC window problem (Eq. 10), in torch.

    max_{n^o, n^s}  Ṽ(Z_t-1 + alpha * units) - sum_tau (n^o p^o + n^s p^s_tau)

Port of the JAX package's ``core/window_opt.py``. With H linear (beta=0, the
paper's evaluation setting) a decision is a multiset of (slot, instance)
units, each adding alpha workload at its own price; per-slot supply is
min(avail, Nmax) spot units at p^s plus on-demand units at p^o, capped at
Nmax. Ṽ is piecewise-linear and NOT concave, so the solver evaluates the
objective at every prefix length with a min-plus DP over slots and takes
the argmax. Slots past the job deadline are priced out (BIG).

Backends (``backend=`` on :func:`solve_window_batch`):

``"cuda"``   kernel K1 (repro_torch.kernels.window_dp). A call with one job
             per row (the pool simulator's, each slot) takes K1's forecast
             entry, ``window_dp_rows``: one launch reads the rows' forecasts
             and job fields and writes the split plan and the objective,
             with no table, split or un-bias op around it. A call with one
             shared scalar job (:func:`solve_window`) builds the unit-cost
             table in torch ops (its python-scalar subexpressions round in
             f64, as the reference's weak scalars do) and takes the table
             entry, ``window_dp``.
``"torch"``  the plain chain in torch ops: :func:`_unit_cost_table`,
             ``kernels.ref.window_dp_ref`` and :func:`split_plan`
             (:func:`window_dp_rows_ref` for per-row calls, also the
             forecast entry's plain version).

The default follows the device: ``"cuda"`` for the card, ``"torch"`` for the
CPU. Both give bit-equal results on the same inputs.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.job import tilde_value
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.ref import BIG, window_dp_ref
from repro_torch.kernels.window_dp import window_dp, window_dp_rows

# Deterministic near-tie resolution, kept exactly as in the reference: the
# gain is biased by -TIE_EPS per unit so every near-tie (true marginal value
# < TIE_EPS) resolves to FEWER units whatever FMA contraction a compiler
# applied to the cost/gain products (XLA, nvcc and PyTorch's CPU kernels
# differ there). 2^-10 is exact in f32; the reported objective is
# un-biased before returning.
TIE_EPS = 2.0 ** -10

BACKENDS = ("cuda", "torch")

_JOB_DTYPES = {
    "workload": torch.float32, "deadline": torch.int32,
    "n_min": torch.int32, "n_max": torch.int32, "value": torch.float32,
    "gamma": torch.float32, "on_demand_price": torch.float32,
}


def _col(x, nd: int):
    """A (B,) tensor as (B, 1, ..., 1) with ``nd`` trailing axes; python
    scalars pass through (they broadcast as the reference's weak scalars)."""
    if torch.is_tensor(x):
        return x.reshape(x.shape + (1,) * nd)
    return x


def _unit_cost_table(job: JobConfig, tput: ThroughputConfig, z0,
                     slots_to_deadline, prices, avail, p_o, tn: int):
    """Row-batched DP tables, shared by every backend.

    z0 (B,) f32, slots_to_deadline (B,) i32, prices (B, w1) f32, avail
    (B, w1) i32; ``job`` fields and ``p_o`` are python scalars (one job for
    every row) or (B,) tensors (one job per row). Returns (slot_cost
    (B, w1, tn+1), spot_units (B, w1) i32, gain (B, U+1)): slot_cost[b,
    tau, k] is the cheapest cost of buying k units in slot tau (spot-first
    split; infeasible k priced out with BIG) and gain[b, u] is
    Ṽ(z0 + alpha * u) - TIE_EPS * u. Every op is elementwise, as in the
    reference's vmapped per-row table. K1's forecast entry
    (kernels/csrc/window_dp.cu) repeats each of these f32 ops, and
    ``core/job.tilde_value``'s, in the same order: a change here is made
    there too."""
    dev = prices.device
    w1 = prices.shape[1]
    nmax2, nmax3 = _col(job.n_max, 1), _col(job.n_max, 2)
    p_o2, p_o3 = _col(p_o, 1), _col(p_o, 2)

    in_horizon = (torch.arange(w1, device=dev)[None, :]
                  < slots_to_deadline[:, None])                  # (B, w1)
    spot_ok = (prices <= p_o2) & in_horizon
    cap = torch.minimum(avail, torch.as_tensor(nmax2, dtype=torch.int32,
                                               device=dev))
    spot_units = torch.where(spot_ok, cap, 0)                    # (B, w1)

    ks = torch.arange(tn + 1, device=dev).to(torch.float32)[None, None, :]
    n_sp = torch.minimum(ks, spot_units[..., None].to(torch.float32))
    # one rounding for the multiply-add, as the reference's compiled
    # program has it (XLA contracts it into an FMA); the f64 sum is exact
    # (n_sp <= 127 units times an f32 price plus an f32 term)
    slot_cost = (n_sp.double() * prices[..., None].double()
                 + ((ks - n_sp) * p_o3).double()).to(torch.float32)
    feasible_k = (ks == 0) | (
        (ks >= _col(job.n_min, 2)) & (ks <= nmax3) & in_horizon[..., None]
    )
    slot_cost = torch.where(feasible_k, slot_cost, BIG)

    u_grid = torch.arange(w1 * tn + 1, device=dev).to(torch.float32)
    zs = z0[:, None] + tput.alpha * u_grid[None, :]
    row_job = JobConfig(**{f: _col(getattr(job, f), 1) for f in _JOB_DTYPES})
    gain = tilde_value(row_job, tput, zs) - TIE_EPS * u_grid[None, :]
    return slot_cost.contiguous(), spot_units, gain.contiguous()


def split_plan(n_tot, spot_units, obj):
    """A DP plan as the solver returns it: spot first (n_s = min(n_tot,
    spot_units)), the rest on demand, and the objective un-biased by
    TIE_EPS per unit. Returns (n_o, n_s, obj)."""
    n_s = torch.minimum(n_tot, spot_units).to(torch.int32)
    n_o = n_tot - n_s
    obj = obj + TIE_EPS * n_tot.sum(dim=1).to(torch.float32)
    return n_o, n_s, obj


def window_dp_rows_ref(job: JobConfig, tput: ThroughputConfig, z0,
                       slots_to_deadline, prices, avail, tn: int):
    """K1's forecast entry in torch ops (its plain version):
    :func:`_unit_cost_table`, ``kernels.ref.window_dp_ref`` and
    :func:`split_plan`.

    ``job`` holds (B,) tensors in the reference's dtypes, its
    ``on_demand_price`` the rows' p_o; z0 (B,) f32, slots_to_deadline (B,)
    i32, prices (B, w1) f32, avail (B, w1) i32. Returns (n_o (B, w1) i32,
    n_s (B, w1) i32, obj (B,) f32)."""
    slot_cost, spot_units, gain = _unit_cost_table(
        job, tput, z0, slots_to_deadline, prices, avail,
        job.on_demand_price, tn)
    n_tot, obj = window_dp_ref(slot_cost, gain)
    return split_plan(n_tot, spot_units, obj)


def _per_row_job(job: JobConfig, p_o, b: int, dev):
    """(job, p_o) with every field a (B,) tensor of the reference's dtype.
    As in the reference's per-row table, the row's ``p_o`` is also its
    job's on-demand price."""
    p_o = to_device(p_o, torch.float32, dev).expand(b)
    fields = {
        f: to_device(getattr(job, f), dt, dev).expand(b)
        for f, dt in _JOB_DTYPES.items() if f != "on_demand_price"
    }
    return JobConfig(on_demand_price=p_o, **fields), p_o


def _solve_batch(slot_cost, gain, backend: str):
    """DP forward + objective argmax + backtrack on the chosen backend."""
    if backend == "cuda":
        return window_dp(slot_cost, gain)
    return window_dp_ref(slot_cost, gain)


def _solve_rows(job: JobConfig, tput: ThroughputConfig, z0,
                slots_to_deadline, prices, avail, tn: int, backend: str):
    """One job per row: K1's forecast entry, or its plain chain."""
    if backend == "cuda":
        return window_dp_rows(job, tput, z0, slots_to_deadline, prices,
                              avail, tn)
    return window_dp_rows_ref(job, tput, z0, slots_to_deadline, prices,
                              avail, tn)


def solve_window_batch(
    job: JobConfig,
    tput: ThroughputConfig,
    z0,                         # (B,) progress per row
    slots_to_deadline,          # (B,) per-row window cut-off
    prices,                     # (B, w1) per-row predicted spot prices
    avail,                      # (B, w1) per-row predicted availability
    p_o,
    table_n: int,               # unit-table width
    backend: Optional[str] = None,
    device=None,
):
    """Solve a whole batch of window problems with ONE DP call (one K1
    launch on the card) — what the pool simulator issues per market slot.
    With per-row job fields that launch is all the call issues on the card:
    K1's forecast entry builds the tables and splits the plan itself.

    ``job`` fields (and ``p_o``) are python scalars shared by every row, or
    (B,) arrays with one job per row. Inputs are moved to ``device`` (None:
    the card). Returns (n_o (B, w1) i32, n_s (B, w1) i32, objective (B,))."""
    dev = resolve_device(device)
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    tn = int(table_n)
    if tn < 1:
        raise ValueError(f"table_n must be >= 1, got {table_n}")
    prices = to_device(prices, torch.float32, dev)
    avail = to_device(avail, torch.int32, dev)
    z0 = to_device(z0, torch.float32, dev)
    std = to_device(slots_to_deadline, torch.int32, dev)
    b = prices.shape[0]
    z0, std = z0.expand(b), std.expand(b)

    is_array = lambda x: torch.is_tensor(x) or np.ndim(x) > 0
    if is_array(p_o) or any(is_array(getattr(job, f)) for f in _JOB_DTYPES):
        job, _ = _per_row_job(job, p_o, b, dev)
        # K1 takes dense rows; the pool simulator's already are (no copy)
        job = JobConfig(**{f: getattr(job, f).contiguous()
                           for f in _JOB_DTYPES})
        return _solve_rows(job, tput, z0.contiguous(), std.contiguous(),
                           prices.contiguous(), avail.contiguous(), tn,
                           backend)
    slot_cost, spot_units, gain = _unit_cost_table(
        job, tput, z0, std, prices, avail, p_o, tn
    )
    n_tot, obj = _solve_batch(slot_cost, gain, backend)
    return split_plan(n_tot, spot_units, obj)


def solve_window(job: JobConfig, tput: ThroughputConfig, z0,
                 slots_to_deadline, prices, avail, p_o: float,
                 table_n: int = 0, backend: Optional[str] = None,
                 device=None):
    """One window (w1 slots): returns (n_o (w1,), n_s (w1,), objective).
    ``table_n`` 0 uses the job's N^max as the unit-table width."""
    tn = int(table_n) if table_n else int(job.n_max)
    dev = resolve_device(device)
    n_o, n_s, obj = solve_window_batch(
        job, tput, to_device([z0], torch.float32, dev),
        to_device([slots_to_deadline], torch.int32, dev),
        to_device(prices, torch.float32, dev)[None],
        to_device(avail, torch.int32, dev)[None],
        p_o, tn, backend=backend, device=dev,
    )
    return n_o[0], n_s[0], obj[0]


def solve_window_numpy(job: JobConfig, tput: ThroughputConfig, z0,
                       slots_to_deadline, prices, avail, p_o: float,
                       device=None):
    """The python policies' window solve: one window through
    :func:`solve_window` on ``device`` (None: the card, where it is one
    launch of K1's table entry), the plan brought back to the host.
    Returns (n_o (w1,) numpy i32, n_s (w1,) numpy i32, objective float)."""
    n_o, n_s, obj = solve_window(
        job, tput, np.float32(z0), np.int32(slots_to_deadline),
        np.asarray(prices, np.float32), np.asarray(avail, np.int32),
        float(p_o), device=device,
    )
    return n_o.cpu().numpy(), n_s.cpu().numpy(), float(obj)


def brute_force_window(job, tput, z0, slots_to_deadline, prices, avail, p_o):
    """Exponential-time exact reference (tests only): enumerates per-slot
    totals in {0} u [Nmin, Nmax], spot-first split. Returns (objective,
    per-slot totals)."""
    prices = np.asarray(prices, float)
    avail = np.asarray(avail, int)
    w1 = len(prices)
    choices = [0] + list(range(job.n_min, job.n_max + 1))
    horizon = min(int(slots_to_deadline), w1)
    best = (-np.inf, None)
    for plan in itertools.product(choices, repeat=horizon):
        z, cost = float(z0), 0.0
        for tau, n in enumerate(plan):
            ns = min(n, avail[tau]) if prices[tau] <= p_o else 0
            cost += ns * prices[tau] + (n - ns) * p_o
            z += tput.alpha * n + (tput.beta if n > 0 else 0.0)
        u = float(tilde_value(job, tput, torch.tensor(z))) - cost
        if u > best[0]:
            best = (u, list(plan) + [0] * (w1 - horizon))
    return best
