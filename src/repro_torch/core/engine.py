"""Online selection engine: the paper's Algorithm 2 loop (simulate every
pool policy on the incoming jobs -> normalize utilities -> EG update) end to
end on one device, with the (K, M) utility matrix never leaving it. Port of
the JAX package's ``core/engine.py`` (single region, numpy prep path).

  prep      batched trace-window gather (market.gather_windows) + ONE
            vectorized forecast stack (predictor.noisy_matrix_batch) — host
            numpy
  simulate  fast_sim.simulate_pool_jobs (one K1 launch per market slot on
            the card)
  select    job.normalize_utility_batch + selector.run_eg_scan

The job axis streams in chunks (``job_chunk``); the EG state threads through
the chunks, so chunked and unchunked runs agree (the trajectories bitwise,
the mean-utility accumulator to f32 tolerance).

``collect=True`` turns the flight recorder on end to end (the simulator's
``tel_*`` series, the EG loop's entropy and leader traces; repro_torch.obs
folds them into ledgers) and ``fallback=`` arms the AHAP lanes'
prediction-failure monitor (repro_torch.chaos). Both defaults run the ops
of the program without them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import fast_sim, selector
from repro_torch.core.job import normalize_utility_batch
from repro_torch.core.market import gather_windows, require_finite
from repro_torch.core.predictor import noisy_matrix_batch
from repro_torch.device import resolve_device


def prepare_noisy_inputs(trace, t0s, deadline: int, kind: str, level,
                         seeds, horizon: Optional[int] = None,
                         avail_max: int = 16):
    """Batched Fig. 9-style prep: gather the K job windows in one indexing
    pass and emit the whole noisy forecast stack in one vectorized call.
    Returns numpy ``(prices (K, d) f32, avail (K, d) i64,
    preds (K, d, W1MAX, 2) f32)``; row k equals the per-job
    ``NoisyPredictor(trace.window(t0s[k], d+1), ..., seed=seeds[k])``.
    ``level`` is a scalar or a per-row (K,) array."""
    horizon = fast_sim.W1MAX - 1 if horizon is None else horizon
    pw, aw = gather_windows(trace, t0s, deadline + 1)
    preds = noisy_matrix_batch(pw, aw, kind, level, seeds, horizon,
                               avail_max)[:, :deadline]
    require_finite("forecast stack", preds)
    return (pw[:, :deadline].astype(np.float32),
            aw[:, :deadline].astype(np.int64),
            preds.astype(np.float32))


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


def simulate_and_select(
    pool_arrays: dict,
    jobs: fast_sim.JobArrays,
    tput: ThroughputConfig,
    prices, avail, preds,
    *,
    backend: Optional[str] = None,
    device=None,
    eta: Optional[float] = None,
    state: Optional[selector.EGState] = None,
    job_chunk: int = 0,
    track_history: bool = False,
    return_utilities: bool = False,
    collect: bool = False,
    fallback=None,
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

    ``collect=True`` adds the flight recorder: ``sim_out`` holds the whole
    simulator output with its (K, M, T) ``tel_*`` series (chunks
    concatenated along the job axis, kept on the device and copied to the
    host once, after the last chunk), and ``entropy`` / ``top_policy`` the
    EG loop's per-job traces. ``fallback`` takes a
    :class:`repro_torch.chaos.FallbackConfig` to arm the AHAP lanes'
    prediction-failure monitor."""
    dev = resolve_device(device)
    n_jobs = int(np.shape(jobs.workload)[0])
    n_pol = int(np.shape(pool_arrays["kind"])[0])
    if state is None:
        state = selector.eg_init(n_pol, n_jobs, eta=eta, device=dev)
    chunk = int(job_chunk) if job_chunk else n_jobs
    if chunk < 1:
        raise ValueError(f"job_chunk must be >= 1, got {job_chunk}")
    jobs = fast_sim.jobs_to(jobs, dev)

    u_sum = torch.zeros((n_pol,), dtype=torch.float32, device=dev)
    max_w, regrets, hist, raw = [], [], [], []
    ent, top, sim_chunks = [], [], []
    for lo in range(0, n_jobs, chunk):
        hi = min(lo + chunk, n_jobs)
        jb = fast_sim.slice_jobs(jobs, lo, hi)
        out = fast_sim.simulate_pool_jobs(
            pool_arrays, jb, tput, prices[lo:hi], avail[lo:hi],
            preds[lo:hi], backend=backend, device=dev, collect=collect,
            fallback=fallback,
        )
        u = out["utility"]                       # (k, M), stays on device
        u_sum = u_sum + u.sum(dim=0)
        state, traj = _normalize_and_scan(jb, u, state, track_history,
                                          collect)
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
