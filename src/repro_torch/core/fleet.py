"""Fleet-scale multi-job contention engine in torch. Port of the JAX
package's ``core/fleet.py`` (its unsharded engine).

The paper's Sec. III-A extension (jobs arriving over time and competing
for one finite spot pool under least-slack-first arbitration) as one loop
over market slots with the job axis batched on one device. Semantics are
those of the host oracle ``core.multi_job.MultiJobScheduler``:

  * **demand**: every live job's policy decides against the FULL slot
    supply. AHAP jobs take ``fast_sim._ahap_rule_batch`` with the jobs as
    lanes and per-job local clocks ``t - arrival``: ONE
    ``solve_window_batch`` call a slot, one launch of K1's forecast entry
    on the card. The five cheap kinds run their vectorized rules;
  * **waterfall**: spot demand is granted least-slack-first as a sort and a
    cumulative-supply clip: with demands sorted by the f32 slack key (job
    id breaking ties), ``grant_i = clip(S - (cumsum(d)_i - d_i), 0, d_i)``
    makes the cumulative grants ``min(cumsum(d), S)``, integer-exact, the
    oracle's sequential residual loop;
  * **execute**: ``fast_sim._execute`` on the granted spot, arrivals and
    retirements gated by ``t - arrival`` masks.

Sharding (:func:`simulate_fleet_sharded`) lays the job axis over the pool
mesh's ``"jobs"`` axis, one rank a shard (2-D meshes replicate over
``"lanes"``: the fleet has no lane axis). Each rank holds an equal ``[AHAP
block | cheap block]`` slice, both blocks padded to the rank count with
``arrival = T`` sentinel jobs (never live, zero demand), and each slot
all-gathers (demand, slack) over the ``"jobs"`` group: every rank grants
the identical global order and keeps its own slice, so the result equals
the unsharded loop's bit for bit.

Per-job policy rows come from EG selector weights
(:func:`policy_rows_from_weights`, ``engine.SelectionResult.
admission_rows``): the select -> admit loop.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import fast_sim
from repro_torch.core.fast_sim import VMAX, W1MAX, JobArrays
from repro_torch.core.policy_pool import KIND_AHAP
from repro_torch.device import resolve_device, to_device

_POLICY_KEYS = ("kind", "omega", "v", "sigma", "rho", "cfrac")
_I32, _F32 = torch.int32, torch.float32


# ---------------------------------------------------------------------------
# Least-slack-first waterfall
# ---------------------------------------------------------------------------

def _lexsort(keys):
    """``jnp.lexsort(keys)``: the permutation that sorts by the LAST key,
    ties broken by the one before it, and so on. Stable sorts from the
    least significant key up; a stable sort keeps input order among equal
    keys, so every earlier key's order survives."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _waterfall(demand, slack, ids, supply):
    """Grant ``demand`` (i32) in ascending ``(slack, id)`` order against the
    slot's ``supply`` ((1,) i32). Cumulative grants equal
    ``min(cumsum(demand), supply)``: each job takes ``min(demand,
    residual)``, integer-exact."""
    order = _lexsort((ids, slack))
    d_sorted = demand[order]
    cum = torch.cumsum(d_sorted, dim=0, dtype=_I32)
    g_sorted = torch.minimum(torch.clamp_min(supply - (cum - d_sorted), 0),
                             d_sorted)
    return torch.empty_like(demand).scatter_(0, order, g_sorted)


def _demand_rank(demand, slack, ids):
    """Flight-recorder companion to :func:`_waterfall`: each job's position
    in the demanders-only grant order (-1 for jobs demanding nothing this
    slot). Demanders sort first (a ``demand <= 0`` key ahead of the same
    ``(slack, id)`` keys), so their positions do not depend on which
    zero-demand jobs are present. Only run when ``collect=True``."""
    n = ids.shape[0]
    order = _lexsort((ids, slack, (demand <= 0).to(_I32)))
    pos = torch.empty_like(ids).scatter_(
        0, order, torch.arange(n, dtype=_I32, device=ids.device))
    return torch.where(demand > 0, pos, -1)


# ---------------------------------------------------------------------------
# The fleet loop
# ---------------------------------------------------------------------------

_TEL_FLEET = ("tel_demand", "tel_grant", "tel_slack", "tel_rank",
              "tel_starved")


def _fleet_scan(pol, jobs: JobArrays, arrivals, ids, tput, prices, avail,
                pred, backend, device, n_ahap: int, collect: bool = False,
                fallback=None, group=None):
    """One loop over market slots for a fleet (or a rank's shard of one) on
    ``device``.

    ``jobs`` / ``arrivals`` / ``ids`` are (J,) tensors ordered ``[AHAP
    block | cheap block]``, split at ``n_ahap``; ``pol`` holds the per-job
    policy rows in the same order. ``prices`` / ``avail`` / ``pred`` are
    the shared market ((T,), (T,), (T, W1MAX, 2)), the present slot's
    forecast already clamped to the supply. ``collect`` adds the
    ``fast_sim._TEL_SLOTS`` slot series (preemption: the grant fell below
    last slot's allocation) and the ``_TEL_FLEET`` waterfall series.
    ``fallback`` (a chaos.FallbackConfig, or None) arms a per-job
    forecast-error EWMA over the shared market for the AHAP block, updated
    once a job has arrived; above the threshold the job demands by the
    AHANP rule, whose "previous availability" is the shifted supply. With
    collect also on, the ``fast_sim._TEL_FALLBACK`` series join (all zero
    for the cheap block).

    With a process ``group`` (the pool mesh's ``"jobs"`` group) these are
    this rank's rows: the ids are gathered once, and each slot (demand,
    slack) is gathered over the group, in its own dtype, so that every rank
    runs the waterfall (and the rank of ``collect``) on the whole fleet and
    keeps its own slice."""
    dmax = prices.shape[0]
    n_jobs = arrivals.shape[0]
    has_ahap = n_ahap > 0
    has_cheap = n_jobs - n_ahap > 0
    # AHANP observes last slot's availability: in the fleet every job sees
    # the shared pool, so it is the shifted supply (a job's first live slot
    # sees the current supply, like the python policy's first decide)
    sup_prev = torch.cat([avail[:1], avail[:-1]])

    fb_on = fallback is not None and has_ahap
    if fb_on:
        fb_thr = fast_sim._f32(fallback.threshold)
        prev1 = fast_sim._fallback_prev1(pred[None])             # (1, T, 2)
        err = torch.zeros((1, n_ahap), dtype=_F32, device=device)

    ja = fast_sim.slice_jobs(jobs, 0, n_ahap)
    jc = fast_sim.slice_jobs(jobs, n_ahap, n_jobs)
    if has_ahap:
        # the AHAP jobs are the lanes of one (1, Ja) batch: job fields as
        # (1, Ja) rows and (1, Ja, 1) columns, one local clock per lane
        rows = fast_sim._job_cfg(ja)
        j_a = JobArrays(*[f[None] for f in ja])
        j3_a = JobArrays(*[f[None, :, None] for f in ja])
        omega_a, sigma_a = pol["omega"][:n_ahap], pol["sigma"][:n_ahap]
        rho_a, v_a = pol["rho"][:n_ahap], pol["v"][:n_ahap]
        arr_a = arrivals[:n_ahap][None]
        plans = torch.zeros((1, n_ahap, VMAX, W1MAX, 2), dtype=_F32,
                            device=device)
    if has_cheap:
        kind_c = pol["kind"][n_ahap:]
        sigma_c = pol["sigma"][n_ahap:]
        cfrac_c = pol["cfrac"][n_ahap:]

    if group is not None:
        import torch.distributed as dist

        from repro_torch.launch.mesh import all_gather

        ids_all = torch.cat([p[0] for p in all_gather([ids], group)])
        start = dist.get_rank(group) * n_jobs
        mine = slice(start, start + n_jobs)

    h_max = tput.alpha * jobs.n_max.to(_F32) + tput.beta
    z, n_prev, cost, done, T = (s[:, 0] for s in
                                fast_sim._init_state(n_jobs, 1, device))
    negative_zero = torch.zeros((), dtype=torch.bool, device=device)
    no_hist, ns_hist, tel = [], [], []
    for t in range(dmax):
        price, sup, sup_p = (prices[t:t + 1], avail[t:t + 1],
                             sup_prev[t:t + 1])
        lt = t - arrivals
        live = (lt >= 0) & (lt < jobs.deadline) & ~done

        # ---- demand: every policy decides at the FULL supply
        d_o_parts, d_s_parts = [], []
        if has_ahap:
            lt_a = t - arr_a                                   # (1, Ja)
            pr_t, thr_t, zee_t, eff_t = fast_sim._ahap_precompute(
                j3_a, omega_a, sigma_a, rho_a, lt_a, pred[None, t])
            d_o_a, d_s_a, plans = fast_sim._ahap_rule_batch(
                rows, j_a, tput, v_a, backend, device, z[None, :n_ahap],
                lt_a, price, sup, plans, pr_t, thr_t, zee_t, eff_t)
            if fb_on:
                # the monitor accumulates once the job watches the market
                # (has arrived); the error sample is the shared market's
                err = torch.where(
                    lt_a >= 0,
                    fast_sim._fallback_error(fallback, err, price[None],
                                             sup[None], prev1[:, t]),
                    err)
                fb = err > fb_thr
                pa_a = torch.where(lt_a >= 1, sup_p, sup)
                an_o, an_s = fast_sim._ahanp_rule(
                    j_a, sigma_a[None], z[None, :n_ahap], lt_a, price, sup,
                    n_prev[None, :n_ahap], pa_a)
                d_o_a = torch.where(fb, an_o, d_o_a)
                d_s_a = torch.where(fb, an_s, d_s_a)
            d_o_parts.append(d_o_a[0])
            d_s_parts.append(d_s_a[0])
        if has_cheap:
            ltc = lt[n_ahap:]
            pa = torch.where(ltc >= 1, sup_p, sup)
            c_o, c_s = fast_sim._cheap_rules(
                kind_c, sigma_c, cfrac_c, jc, tput, z[n_ahap:], ltc, price,
                sup, n_prev[n_ahap:], pa)
            d_o_parts.append(c_o)
            d_s_parts.append(c_s)
        d_o = torch.cat(d_o_parts) if len(d_o_parts) > 1 else d_o_parts[0]
        d_s = torch.cat(d_s_parts) if len(d_s_parts) > 1 else d_s_parts[0]
        # demand clip against the full pool; dead jobs demand nothing
        d_s = torch.minimum(torch.clamp_min(d_s, 0),
                            torch.minimum(sup, jobs.n_max))
        d_o = torch.minimum(torch.clamp_min(d_o, 0), jobs.n_max - d_s)
        d_s = torch.where(live, d_s, 0)
        d_o = torch.where(live, d_o, 0)

        # ---- waterfall: least-slack-first grants
        slack = ((arrivals + jobs.deadline - t).to(_F32)
                 - torch.clamp_min(jobs.workload - z, 0.0) / h_max)
        # the sort keeps -0.0 and +0.0 apart where the reference's does
        # not; the key is built so -0.0 cannot occur (a difference of an
        # integer and a non-negative quotient), checked once after the loop
        negative_zero |= ((slack == 0) & torch.signbit(slack)).any()
        if group is None:
            grant = _waterfall(d_s, slack, ids, sup)
            if collect:
                rank = _demand_rank(d_s, slack, ids)
        else:
            parts = all_gather([d_s, slack], group)
            d_all = torch.cat([p[0] for p in parts])
            s_all = torch.cat([p[1] for p in parts])
            grant = _waterfall(d_all, s_all, ids_all, sup)[mine]
            if collect:
                rank = _demand_rank(d_all, s_all, ids_all)[mine]

        # ---- execute: local clock, pre-arrival masked to inactive
        mt = torch.where(lt >= 0, lt, jobs.deadline)
        n_prev0 = n_prev
        z, n_prev, cost, done, T, n_o, n_s, active = fast_sim._execute(
            jobs, tput, z, n_prev, cost, done, T, mt, d_o, grant, price,
            grant)
        no_hist.append(n_o)
        ns_hist.append(n_s)
        if collect:
            sample = fast_sim._slot_telemetry(
                jobs, n_prev0, z, n_o, n_s, active, price, grant) + (
                d_s, grant, torch.where(live, slack, 0.0), rank,
                live & (d_s > 0) & (grant < d_s))
            if fallback is not None:
                fb_all = torch.zeros((n_jobs,), dtype=torch.bool,
                                     device=device)
                err_all = torch.zeros((n_jobs,), dtype=_F32, device=device)
                if fb_on:
                    fb_all[:n_ahap] = fb[0]
                    err_all[:n_ahap] = err[0]
                sample += (fb_all, err_all)
            tel.append(sample)
    if bool(negative_zero):
        raise AssertionError("fleet slack key took the value -0.0")
    out = fast_sim._finalize(jobs, tput, z, cost, done, T, no_hist, ns_hist)
    if collect:
        keys = fast_sim._TEL_SLOTS + _TEL_FLEET + (
            fast_sim._TEL_FALLBACK if fallback is not None else ())
        out.update(fast_sim._telemetry_out(keys, tel))
    return out


# ---------------------------------------------------------------------------
# Host-side prep: policy rows, market tensors, kind blocking
# ---------------------------------------------------------------------------

def _norm_rows(pool_rows):
    """Per-job policy rows as host arrays with engine dtypes + defaults."""
    kind = np.asarray(fast_sim._host(pool_rows["kind"]), np.int32)
    n = kind.shape[0]

    def get(key, default, dt):
        return np.asarray(fast_sim._host(pool_rows.get(key, default)), dt)

    rows = {
        "kind": kind,
        "omega": get("omega", np.zeros(n), np.int32),
        "v": np.maximum(get("v", np.ones(n), np.int32), 1),
        "sigma": get("sigma", np.zeros(n), np.float32),
        "rho": get("rho", np.ones(n), np.float32),
        "cfrac": get("cfrac", np.zeros(n), np.float32),
    }
    return rows, n


def _prepare_market(prices, avail, pred):
    """f32 / int market arrays with the oracle's present-slot clamp:
    ``pred[t, 0, 1] <- min(pred[t, 0, 1], avail[t])`` (the pool caps what
    the present slot can deliver; future rows stay the global forecast).
    ``pred=None`` is a persistence forecast (present price and supply
    repeated over the horizon)."""
    prices = np.asarray(fast_sim._host(prices), np.float32)
    avail = np.asarray(fast_sim._host(avail))
    dmax = prices.shape[0]
    if pred is None:
        base = np.stack([prices, avail.astype(np.float32)], axis=-1)
        pred = np.broadcast_to(base[:, None, :], (dmax, W1MAX, 2))
    pred = np.array(fast_sim._host(pred), dtype=np.float32, copy=True)
    pred[:, 0, 1] = np.minimum(pred[:, 0, 1], avail.astype(np.float32))
    return prices, avail, pred


def _take_jobs(jobs: JobArrays, idx) -> JobArrays:
    return JobArrays(*[np.asarray(fast_sim._host(f))[idx] for f in jobs])


def _fleet_host(pool_rows, jobs: JobArrays, arrivals, prices, avail, pred):
    """Both engines' host prep: (rows, n, arrivals (J,) i32, prices,
    avail, pred), the row count checked against the jobs' and the
    arrivals'."""
    rows, n = _norm_rows(pool_rows)
    arrivals = np.asarray(fast_sim._host(arrivals), np.int32)
    if not n == int(np.shape(jobs.workload)[0]) == int(arrivals.shape[0]):
        raise ValueError(f"{n} policy rows, {np.shape(jobs.workload)[0]} "
                         f"jobs and {arrivals.shape[0]} arrivals")
    return (rows, n, arrivals) + _prepare_market(prices, avail, pred)


# policy-row dtypes on the device (the rest are i32)
_POL_DTYPES = {"sigma": _F32, "rho": _F32, "cfrac": _F32}


def _scan_rows(rows, jobs: JobArrays, idx, arrivals, ids, market, tput,
               backend, dev, n_ahap: int, collect, fallback, group=None):
    """:func:`_fleet_scan` on ``dev`` over the jobs ``idx`` (host indices
    into ``rows`` and ``jobs``, ordered [AHAP block | cheap block]) with
    their ``arrivals`` and ``ids``; ``market`` is (prices, avail, pred)."""
    prices, avail, pred = market
    pol = {k: to_device(v[idx], _POL_DTYPES.get(k, _I32), dev)
           for k, v in rows.items()}
    return _fleet_scan(
        pol, fast_sim.jobs_to(_take_jobs(jobs, idx), dev),
        to_device(arrivals, _I32, dev), to_device(ids, _I32, dev), tput,
        to_device(prices, _F32, dev), to_device(avail, _I32, dev),
        to_device(pred, _F32, dev), backend, dev, n_ahap, collect, fallback,
        group=group)


def simulate_fleet(pool_rows, jobs: JobArrays, arrivals, tput, prices,
                   avail, pred=None, backend: Optional[str] = None,
                   device=None, collect: bool = False, fallback=None):
    """Simulate a fleet of jobs contending for one spot pool, on ``device``
    (None: the card).

    ``pool_rows``: per-job policy rows (``kind`` / ``omega`` / ``v`` /
    ``sigma`` / ``rho`` / ``cfrac``, each (J,)), e.g. from
    :func:`policy_rows_from_weights`. ``jobs``: stacked (J,) JobArrays
    (``fast_sim.stack_jobs``). ``arrivals``: (J,) absolute arrival slots.
    ``prices`` / ``avail`` / ``pred``: ONE shared market ((T,), (T,),
    optional (T, W1MAX, 2) absolute-time forecasts). ``backend`` picks the
    window DP (None: "cuda" on the card, "torch" on the CPU).

    Returns the ``fast_sim._finalize`` dict (utility / value / cost /
    completion_time / z_ddl / completed and the (J, T) allocation
    histories) in submission order; ``collect`` adds the (J, T) ``tel_*``
    series. Semantics match ``multi_job.MultiJobScheduler``: completion
    times are on each job's local clock."""
    dev = resolve_device(device)
    rows, _, arrivals, *market = _fleet_host(pool_rows, jobs, arrivals,
                                             prices, avail, pred)
    aidx = np.flatnonzero(rows["kind"] == KIND_AHAP)
    cidx = np.flatnonzero(rows["kind"] != KIND_AHAP)
    order = np.concatenate([aidx, cidx]).astype(np.int32)
    out = _scan_rows(rows, jobs, order, arrivals[order], order, market,
                     tput, backend, dev, len(aidx), collect, fallback)
    take = torch.as_tensor(np.argsort(order, kind="stable"), device=dev)
    return {k: v.index_select(0, take) for k, v in out.items()}


def simulate_fleet_sharded(pool_rows, jobs: JobArrays, arrivals, tput,
                           prices, avail, pred=None,
                           backend: Optional[str] = None, mesh=None,
                           collect: bool = False, fallback=None,
                           device=None):
    """:func:`simulate_fleet` with the job axis laid over the pool mesh
    (``launch.mesh.make_pool_mesh``; None: the 1-D pool mesh over the
    default process group if one is initialized). Call it on every rank of
    the mesh with the same inputs; each rank runs its shard on its own
    device (``launch.mesh.rank_device``) and returns the whole result in
    submission order.

    Only the ``"jobs"`` axis shards (lanes replicate), so a lanes-only
    ``(1, n)`` mesh, a one-rank mesh or no process group falls through to
    the unsharded loop (on ``device`` when there is no mesh). Each kind
    block pads to the rank count with ``arrival = T`` sentinel jobs (never
    live, zero demand: inert in the waterfall), and the results equal
    :func:`simulate_fleet`'s bit for bit."""
    from repro_torch.launch.mesh import (all_gather, default_pool_mesh,
                                         pool_mesh_job_axes, rank_device)

    mesh = default_pool_mesh(device) if mesh is None else mesh
    d = 1 if mesh is None else pool_mesh_job_axes(mesh)[1]
    if d <= 1:
        return simulate_fleet(
            pool_rows, jobs, arrivals, tput, prices, avail, pred, backend,
            device if mesh is None else rank_device(mesh), collect, fallback)
    import torch.distributed as dist

    dev = rank_device(mesh)
    group = mesh.get_group("jobs")
    rows, n, arr_np, *market = _fleet_host(pool_rows, jobs, arrivals,
                                           prices, avail, pred)
    dmax = market[0].shape[0]
    aidx = np.flatnonzero(rows["kind"] == KIND_AHAP)
    cidx = np.flatnonzero(rows["kind"] != KIND_AHAP)
    j_a = -(-len(aidx) // d) if len(aidx) else 0   # per-rank block sizes
    j_c = -(-len(cidx) // d) if len(cidx) else 0

    def block(idx, per_rank):
        lay = np.full(d * per_rank, -1, np.int64)
        lay[: len(idx)] = idx
        return lay.reshape(d, per_rank)

    # interleave [AHAP block | cheap block] per rank: every shard has the
    # same (j_a + j_c) structure with the AHAP split at j_a
    lay = np.concatenate([block(aidx, j_a), block(cidx, j_c)], axis=1)
    lay = lay.reshape(-1)
    fill = np.concatenate([
        np.full((d, j_a), aidx[0] if len(aidx) else 0, np.int64),
        np.full((d, j_c), cidx[0] if len(cidx) else 0, np.int64),
    ], axis=1).reshape(-1)
    gidx = np.where(lay >= 0, lay, fill)
    is_pad = lay < 0
    arr_l = arr_np[gidx].copy()
    arr_l[is_pad] = dmax                       # sentinel: never live
    ids_l = np.where(is_pad, n + np.arange(lay.shape[0]), lay)

    # this rank's row of the layout, by its place in the "jobs" group
    per = j_a + j_c
    me = slice(dist.get_rank(group) * per, (dist.get_rank(group) + 1) * per)
    out = _scan_rows(rows, jobs, gidx[me], arr_l[me], ids_l[me], market,
                     tput, backend, dev, j_a, collect, fallback, group=group)
    # every rank's rows (group order is layout order), then the real ids
    # 0..n-1 in submission order; pads (ids >= n) dropped
    keys = list(out)
    parts = all_gather([out[k] for k in keys], group)
    take = torch.as_tensor(np.argsort(ids_l, kind="stable")[:n], device=dev)
    return {k: torch.cat([p[i] for p in parts]).index_select(0, take)
            for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# EG-weighted admission (select -> admit loop)
# ---------------------------------------------------------------------------

def policy_rows_from_weights(pool_arrays, weights, n, rng=None,
                             greedy: bool = False):
    """Per-job policy rows drawn from EG selector weights.

    Algorithm 2's Line 6 "select" generalized to fleet admission: each of
    the ``n`` arriving jobs samples its policy i.i.d. from the selector
    distribution (``greedy=True`` admits everyone on the argmax instead).
    ``pool_arrays`` is the ``specs_to_arrays`` dict the weights were
    learned over. Returns ``(rows, idx)``: the per-job row dict
    :func:`simulate_fleet` takes, and the (n,) pool indices (for building
    the oracle's python policies with ``pool[i].build()``)."""
    from repro_torch.core.selector import sample_policies

    w = np.asarray(fast_sim._host(weights), np.float64)
    if greedy:
        idx = np.full(int(n), int(np.argmax(w)), np.int64)
    else:
        rng = np.random.default_rng(0) if rng is None else rng
        idx = sample_policies(w, int(n), rng)
    rows = {k: np.asarray(fast_sim._host(pool_arrays[k]))[idx]
            for k in _POLICY_KEYS if k in pool_arrays}
    return rows, idx.astype(np.int32)
