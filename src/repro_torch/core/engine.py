"""Online selection engine: the paper's Algorithm 2 loop (simulate every
pool policy on the incoming jobs -> normalize utilities -> EG update) end to
end on one device, with the (K, M) utility matrix never leaving it. Port of
the JAX package's ``core/engine.py``.

  prep      batched trace-window gather (market.gather_windows) + ONE
            vectorized forecast stack: host numpy
            (predictor.noisy_matrix_batch), or drawn on the device
            (``prep_backend="torch"``, predictor.noisy_matrix_batch_torch)
  simulate  fast_sim.simulate_pool_jobs_sharded, or
            fast_sim.simulate_pool_regions_sharded in regional mode (one
            K1 launch per market slot on the card), over the pool mesh
            when a process group is running, else the unsharded scans
  select    job.normalize_utility_batch + selector.run_eg_scan

The job axis streams in chunks (``job_chunk``); the EG state threads through
the chunks, so chunked and unchunked runs agree (the trajectories bitwise,
the mean-utility accumulator to f32 tolerance). ``prep=`` builds each
chunk's inputs on demand and double-buffers them: chunk k+1 is prepared on
the host and copied to the card on a side stream while chunk k runs.

``collect=True`` turns the flight recorder on end to end (the simulator's
``tel_*`` series, the EG loop's entropy and leader traces; repro_torch.obs
folds them into ledgers) and ``fallback=`` arms the AHAP lanes'
prediction-failure monitor (repro_torch.chaos). Both defaults run the ops
of the program without them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import fast_sim, selector
from repro_torch.core.job import normalize_utility_batch
from repro_torch.core.market import gather_windows, require_finite
from repro_torch.core.predictor import (noisy_matrix_batch,
                                       noisy_matrix_batch_torch,
                                       regional_noisy_matrix,
                                       regional_noisy_matrix_torch)
from repro_torch.device import resolve_device, to_device
from repro_torch.launch.mesh import default_pool_mesh, rank_device

PREP_BACKENDS = ("numpy", "torch")


def _check_prep_backend(prep_backend: str) -> None:
    if prep_backend not in PREP_BACKENDS:
        raise ValueError(f"prep_backend {prep_backend!r} not in "
                         f"{PREP_BACKENDS}")


def prepare_noisy_inputs(trace, t0s, deadline: int, kind: str, level,
                         seeds, horizon: Optional[int] = None,
                         avail_max: int = 16, prep_backend: str = "numpy",
                         device=None):
    """Batched Fig. 9-style prep: gather the K job windows in one indexing
    pass and emit the whole noisy forecast stack in one vectorized call.
    Returns ``(prices (K, d) f32, avail (K, d) i64, preds (K, d, W1MAX, 2)
    f32)``; with the numpy backend every part is numpy and row k equals the
    per-job ``NoisyPredictor(trace.window(t0s[k], d+1), ...,
    seed=seeds[k])``. ``level`` is a scalar or a per-row (K,) array.

    ``prep_backend="torch"`` draws the forecast stack on ``device`` (None:
    the card) with ``predictor.noisy_matrix_batch_torch``: ``preds`` comes
    back as a device tensor, equal to the numpy stack in distribution, not
    in bits (exactly the true future at level 0)."""
    _check_prep_backend(prep_backend)
    horizon = fast_sim.W1MAX - 1 if horizon is None else horizon
    pw, aw = gather_windows(trace, t0s, deadline + 1)
    if prep_backend == "torch":
        preds = noisy_matrix_batch_torch(pw, aw, kind, level, seeds, horizon,
                                         avail_max, device)[:, :deadline]
    else:
        preds = noisy_matrix_batch(pw, aw, kind, level, seeds, horizon,
                                   avail_max)[:, :deadline]
        require_finite("forecast stack", preds)
        preds = preds.astype(np.float32)
    return (pw[:, :deadline].astype(np.float32),
            aw[:, :deadline].astype(np.int64),
            preds)


def prepare_noisy_inputs_regions(market, t0s, deadline: int, kind: str,
                                 level, seeds,
                                 horizon: Optional[int] = None,
                                 avail_max: int = 16,
                                 prep_backend: str = "numpy", device=None):
    """Regional :func:`prepare_noisy_inputs`: gather every (job, region)
    window of a :class:`RegionalMarket` and emit the (K, R, d, W1MAX, 2)
    forecast stack in ONE batched pass over the flattened (K*R,) rows.
    Returns ``(prices (K, R, d) f32, avail (K, R, d) i64, preds)`` for
    ``fast_sim.simulate_pool_regions`` / the regional
    :func:`simulate_and_select`.

    Row (k, r) is seeded ``seeds[k] * 1009 + r`` (the convention of
    ``vast_like_regions``), so the numpy path equals stacking per-job
    ``RegionalPredictor(market.window(t0s[k], d+1), lambda tr, r:
    NoisyPredictor(tr, kind, level, seed=seeds[k] * 1009 + r))``.
    ``prep_backend="torch"`` draws the stack on ``device``
    (``regional_noisy_matrix_torch``)."""
    _check_prep_backend(prep_backend)
    horizon = fast_sim.W1MAX - 1 if horizon is None else horizon
    n_regions = market.n_regions
    pws, aws = zip(*(gather_windows(market.region(r), t0s, deadline + 1)
                     for r in range(n_regions)))
    pw = np.stack(pws, axis=1)                    # (K, R, d+1)
    aw = np.stack(aws, axis=1)
    seeds = np.asarray(seeds)
    rseeds = seeds[:, None] * np.int64(1009) + np.arange(n_regions)[None, :]
    if prep_backend == "torch":
        preds = regional_noisy_matrix_torch(
            pw, aw, kind, level, rseeds, horizon, avail_max, device
        )[:, :, :deadline]
    else:
        preds = regional_noisy_matrix(pw, aw, kind, level, rseeds, horizon,
                                      avail_max)[:, :, :deadline]
        require_finite("forecast stack", preds)
        preds = preds.astype(np.float32)
    return (pw[:, :, :deadline].astype(np.float32),
            aw[:, :, :deadline].astype(np.int64),
            preds)


# a chunk's (prices, avail, preds) as the simulator reads them
_INPUT_DTYPES = (torch.float32, torch.int32, torch.float32)
_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


class _Staged:
    """One chunk's (prices, avail, preds) on the device. On the card the
    host arrays are copied from pinned memory on a side stream; ``ready``
    is recorded there after the copies. An input already on the card is
    cast on the current stream, behind the work that wrote it, and never
    touches the side stream. ``take`` makes the current stream wait for
    ``ready``; ``release`` waits for the copies on the host before the
    pinned buffers are dropped, so none is reused while its copy runs."""

    def __init__(self, arrays, dev, stream):
        self.host, self.ready = [], None
        if stream is None:
            self.tensors = [to_device(a, dt, dev) for a, dt in
                            zip(arrays, _INPUT_DTYPES)]
            return
        self.tensors = []
        for a, dt in zip(arrays, _INPUT_DTYPES):
            if torch.is_tensor(a) and a.is_cuda:
                self.tensors.append(a.to(dt))
                continue
            pinned = torch.from_numpy(
                np.ascontiguousarray(a, _NP_DTYPES[dt])).pin_memory()
            self.host.append(pinned)
            with torch.cuda.stream(stream):
                self.tensors.append(pinned.to(dev, non_blocking=True))
        self.ready = torch.cuda.Event()
        self.ready.record(stream)

    def take(self):
        if self.ready is not None:
            cur = torch.cuda.current_stream()
            cur.wait_event(self.ready)
            for t in self.tensors:
                t.record_stream(cur)
        return self.tensors

    def release(self):
        if self.ready is not None:
            self.ready.synchronize()
        self.host = []


def _normalize_and_scan(jobs: fast_sim.JobArrays, u, state: selector.EGState,
                        track_history: bool, collect: bool = False):
    """The select stage: per-job [0,1] normalization of the (K, M)
    raw-utility matrix + the EG loop, on the matrix's device."""
    un = normalize_utility_batch(jobs, u)
    return selector.run_eg_scan(state, un, track_history=track_history,
                                collect=collect)


def select_from_utilities(jobs: fast_sim.JobArrays, utilities,
                          state: selector.EGState,
                          track_history: bool = False,
                          collect: bool = False):
    """The engine's select stage on its own: normalize a (K, M) raw-utility
    tensor per job and run the EG loop from ``state``, on the tensor's
    device. ``jobs`` leaves must be tensors on that device
    (:func:`fast_sim.jobs_to`). Returns ``(final_state, traj)`` as
    :func:`selector.run_eg_scan`."""
    return _normalize_and_scan(jobs, utilities, state, track_history, collect)


@dataclass
class SelectionResult:
    """Output of :func:`simulate_and_select`.

    ``state`` is the final EG selector state (pass it back in to continue
    the stream); the trajectories are host numpy."""
    state: selector.EGState
    mean_utility: np.ndarray              # (M,) raw mean utility per policy
    max_weight: np.ndarray                # (K,) leader weight after each job
    regret: np.ndarray                    # (K,) cumulative regret after each job
    n_jobs: int
    weight_history: Optional[np.ndarray] = None   # (K, M), track_history only
    utilities: Optional[np.ndarray] = None        # (K, M), return_utilities only
    entropy: Optional[np.ndarray] = None          # (K,), collect only
    top_policy: Optional[np.ndarray] = None       # (K,) i32, collect only
    sim_out: Optional[dict] = None                # full sim dict, collect only

    def best_policy(self) -> int:
        return selector.best_policy(self.state)

    def iters_to_half(self) -> int:
        return selector.iters_to_half(self.max_weight)

    def regret_ratio(self) -> float:
        """Final regret over the Theorem 2 bound sqrt(2 K ln M)."""
        m = int(self.state.weights.shape[0])
        return selector.regret(self.state) / selector.regret_bound(
            m, int(self.state.k)
        )

    def admission_rows(self, pool_arrays: dict, n: int, rng=None,
                       greedy: bool = False):
        """Per-job policy rows for fleet admission, drawn from the final EG
        weights: the select -> admit loop (``core.fleet`` takes the rows as
        each arriving job's policy). Returns ``(rows, idx)`` like
        :func:`fleet.policy_rows_from_weights`."""
        from repro_torch.core import fleet  # fleet must not import engine

        return fleet.policy_rows_from_weights(
            pool_arrays, self.state.weights, n, rng=rng, greedy=greedy)


def simulate_and_select(
    pool_arrays: dict,
    jobs: fast_sim.JobArrays,
    tput: ThroughputConfig,
    prices, avail, preds,
    *,
    backend: Optional[str] = None,
    device=None,
    sharded: bool = True,
    mesh=None,
    eta: Optional[float] = None,
    state: Optional[selector.EGState] = None,
    job_chunk: int = 0,
    track_history: bool = False,
    return_utilities: bool = False,
    collect: bool = False,
    fallback=None,
    delta_mig: Optional[int] = None,
    p_od=None,
    prep=None,
) -> SelectionResult:
    """Run the whole online-selection workload in one call: simulate every
    (job, policy) cell, normalize the utilities per job and run the EG
    selector — Fig. 9's four-regime sweep is one call per regime.

    ``jobs`` are stacked (K,) JobArrays (workload.job_stream_arrays or
    fast_sim.stack_jobs); ``prices``/``avail`` are (K, d) and ``preds``
    (K, d, W1MAX, 2) (see :func:`prepare_noisy_inputs`). Everything runs on
    ``device`` (None: the card). ``state`` continues an earlier stream
    (default: a fresh uniform selector with Thm. 2's eta for K jobs);
    ``job_chunk`` > 0 streams the job axis in chunks of that size.
    ``backend`` picks the window DP (None: "cuda" on the card, "torch" on
    the CPU).

    ``sharded`` lays the (jobs x lanes) grid over ``mesh`` (a
    ``launch.mesh.make_pool_mesh`` mesh; None: the 1-D pool mesh over the
    default process group when one is initialized, the unsharded path
    otherwise). Every rank of the mesh calls this with the same inputs,
    simulates its shard on its own device (``launch.mesh.rank_device``,
    which then replaces ``device``) and runs the EG loop replicated over
    the whole utility matrix; the result equals the unsharded one bit for
    bit.

    ``collect=True`` adds the flight recorder: ``sim_out`` holds the whole
    simulator output with its (K, M, T) ``tel_*`` series (chunks
    concatenated along the job axis, kept on the device and copied to the
    host once, after the last chunk), and ``entropy`` / ``top_policy`` the
    EG loop's per-job traces. ``fallback`` takes a
    :class:`repro_torch.chaos.FallbackConfig` to arm the AHAP lanes'
    prediction-failure monitor.

    **Regional mode**: pass ``delta_mig`` (the market's checkpoint-transfer
    cost) to select among region-aware lanes: the inputs become (K, R, d)
    ``prices`` / ``avail`` and (K, R, d, W1MAX, 2) ``preds``
    (:func:`prepare_noisy_inputs_regions`), the simulate leg
    ``fast_sim.simulate_pool_regions``; ``p_od`` forwards the market's
    per-region on-demand multipliers. With R == 1 and no ``p_od`` the result
    equals the single-region engine's on the squeezed inputs, bit for bit.

    ``prep`` streams input construction: ``prep(lo, hi) -> (prices, avail,
    preds)`` makes each chunk's inputs on demand (the array arguments may
    then be None). The chunk loop double-buffers: once chunk k's work is
    queued on the device, chunk k+1 is prepared on the host and, on the
    card, copied from pinned memory on a side stream whose event the
    compute stream waits on. ``prep=None`` slices the passed arrays: the
    same values in the same order, so the results are unchanged."""
    mesh = (default_pool_mesh(device) if mesh is None else mesh) \
        if sharded else None
    dev = resolve_device(device) if mesh is None else rank_device(mesh)
    n_jobs = int(np.shape(jobs.workload)[0])
    n_pol = int(np.shape(pool_arrays["kind"])[0])
    if state is None:
        state = selector.eg_init(n_pol, n_jobs, eta=eta, device=dev)
    chunk = int(job_chunk) if job_chunk else n_jobs
    if chunk < 1:
        raise ValueError(f"job_chunk must be >= 1, got {job_chunk}")
    if prep is None and preds is None:
        raise ValueError("pass (prices, avail, preds) arrays or prep=")
    jobs = fast_sim.jobs_to(jobs, dev)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(lo, hi):
        if prep is not None:
            arrays = prep(lo, hi)
        else:
            arrays = (prices[lo:hi], avail[lo:hi], preds[lo:hi])
        return _Staged(arrays, dev, side)

    if mesh is None:
        sim_jobs, sim_regions = (fast_sim.simulate_pool_jobs,
                                 fast_sim.simulate_pool_regions)
    else:  # the sharded twins (which fall through on one rank)
        sim_jobs = functools.partial(fast_sim.simulate_pool_jobs_sharded,
                                     mesh=mesh)
        sim_regions = functools.partial(
            fast_sim.simulate_pool_regions_sharded, mesh=mesh)
    if delta_mig is not None:
        simulate = lambda jb, p, a, m: sim_regions(
            pool_arrays, jb, tput, p, a, m, backend=backend, device=dev,
            delta_mig=delta_mig, collect=collect, fallback=fallback,
            p_od=p_od)
    else:
        simulate = lambda jb, p, a, m: sim_jobs(
            pool_arrays, jb, tput, p, a, m, backend=backend, device=dev,
            collect=collect, fallback=fallback)

    u_sum = torch.zeros((n_pol,), dtype=torch.float32, device=dev)
    max_w, regrets, hist, raw = [], [], [], []
    ent, top, sim_chunks = [], [], []
    spans = [(lo, min(lo + chunk, n_jobs)) for lo in range(0, n_jobs, chunk)]
    staged = stage(*spans[0])
    for i, (lo, hi) in enumerate(spans):
        jb = fast_sim.slice_jobs(jobs, lo, hi)
        out = simulate(jb, *staged.take())
        u = out["utility"]                       # (k, M), stays on device
        u_sum = u_sum + u.sum(dim=0)
        state, traj = _normalize_and_scan(jb, u, state, track_history,
                                          collect)
        # the chunk's device work is queued: prepare the next one now, so
        # its host prep and copy overlap it
        staged.release()
        if i + 1 < len(spans):
            staged = stage(*spans[i + 1])
        max_w.append(traj["max_weight"])
        regrets.append(traj["regret"])
        if track_history:
            hist.append(traj["weights"])
        if return_utilities:
            raw.append(u)
        if collect:
            ent.append(traj["entropy"])
            top.append(traj["top_policy"])
            sim_chunks.append(out)

    cat = lambda parts: torch.cat(parts).cpu().numpy()
    sim_out = None
    if collect:
        sim_out = {k: cat([c[k] for c in sim_chunks])
                   for k in sim_chunks[0]}
    return SelectionResult(
        state=state,
        mean_utility=u_sum.cpu().numpy() / n_jobs,
        max_weight=cat(max_w),
        regret=cat(regrets),
        n_jobs=n_jobs,
        weight_history=cat(hist) if track_history else None,
        utilities=cat(raw) if return_utilities else None,
        entropy=cat(ent) if collect else None,
        top_policy=cat(top) if collect else None,
        sim_out=sim_out,
    )
