"""Online Policy Selection (Algorithm 2): Exponentiated Gradient over the
policy pool, full-information (every candidate's utility is evaluated per
job). Port of the JAX package's ``core/selector.py``.

Guarantee (Theorem 2): with eta = sqrt(2 ln M / K) and utilities normalized
to [0,1], regret vs the best fixed policy is <= sqrt(2 K ln M).

Two implementations share the update rule:

* ``init_selector``/``update`` — the numpy reference, one job at a time
  (a copy of the reference's loop).
* ``eg_init``/``run_eg_scan`` — the f32 tensor state and a loop over the
  rows of a (K, M) normalized-utility matrix on its device, returning the
  final state plus per-job max-weight / regret trajectories. Same update
  order, clipping and first-max argmax ties as the numpy loop. The dot and
  the sums over M are taken in another order than XLA's, so weights and
  regret match the JAX scan to f32 tolerance, not bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclass
class SelectorState:
    weights: np.ndarray               # (M,) simplex
    eta: float
    k: int = 0
    cum_expected: float = 0.0         # sum_k E_{w_k}[u_k]
    cum_utils: Optional[np.ndarray] = None  # (M,) per-policy cumulative
    weight_history: List[np.ndarray] = field(default_factory=list)
    # record every history_stride-th update (plus the initial weights)
    history_stride: int = 1


def default_eta(n_policies: int, horizon: int) -> float:
    """Theorem 2's learning rate: sqrt(2 ln M / K)."""
    return float(np.sqrt(2.0 * np.log(n_policies) / max(horizon, 1)))


def init_selector(n_policies: int, horizon: int, eta: Optional[float] = None,
                  track_history: bool = False,
                  history_stride: int = 1) -> SelectorState:
    eta = default_eta(n_policies, horizon) if eta is None else eta
    if history_stride < 1:
        raise ValueError(f"history_stride must be >= 1, got {history_stride}")
    st = SelectorState(
        weights=np.full(n_policies, 1.0 / n_policies),
        eta=eta,
        cum_utils=np.zeros(n_policies),
        history_stride=history_stride,
    )
    if track_history:
        st.weight_history.append(st.weights.copy())
    return st


def select(state: SelectorState, rng: np.random.Generator) -> int:
    """Sample the policy to run for the incoming job (Line 6)."""
    return int(rng.choice(len(state.weights), p=state.weights))


def sample_policies(state_or_weights, n: int,
                    rng: np.random.Generator) -> np.ndarray:
    """``n`` i.i.d. draws from the selector distribution: Line 6 of Alg. 2
    vectorized for fleet admission (one policy per arriving job). Accepts a
    SelectorState / EGState or a bare weight vector (numpy or a tensor);
    the weights are renormalized in f64 (the device state is f32)."""
    w = _np(getattr(state_or_weights, "weights", state_or_weights)).astype(
        np.float64)
    w = np.maximum(w, 0.0)
    w = w / w.sum()
    return rng.choice(len(w), size=int(n), p=w)


def update(state: SelectorState, utilities: np.ndarray,
           track_history: bool = False) -> SelectorState:
    """EG / multiplicative-weights update (Lines 7-11). ``utilities`` must be
    normalized to [0, 1]."""
    u = np.clip(np.asarray(utilities, float), 0.0, 1.0)
    assert u.shape == state.weights.shape
    state.cum_expected += float(np.dot(state.weights, u))
    state.cum_utils += u
    logits = np.log(np.maximum(state.weights, 1e-300)) + state.eta * u
    logits -= logits.max()
    w = np.exp(logits)
    state.weights = w / w.sum()
    state.k += 1
    if track_history and state.k % state.history_stride == 0:
        state.weight_history.append(state.weights.copy())
    return state


def regret(state) -> float:
    """max_m sum_k u_k^m - sum_k E_{w_k}[u_k] (cumulative, Theorem 2 LHS).
    Accepts SelectorState and EGState alike (same field names)."""
    return float(_np(state.cum_utils).max() - _np(state.cum_expected))


def regret_bound(n_policies: int, k: int) -> float:
    return float(np.sqrt(2.0 * k * np.log(n_policies)))


def best_policy(state) -> int:
    """The leader (first max on ties) of a SelectorState or EGState."""
    return int(np.argmax(_np(state.weights)))


class EGState(NamedTuple):
    """Selector state as f32 tensors on one device — field names mirror
    SelectorState so ``regret``/``best_policy`` work on both."""
    weights: torch.Tensor       # (M,) simplex
    eta: torch.Tensor           # f32 scalar
    k: torch.Tensor             # i32 scalar, updates applied so far
    cum_expected: torch.Tensor  # f32 scalar
    cum_utils: torch.Tensor     # (M,)


def eg_init(n_policies: int, horizon: int, eta: Optional[float] = None,
            device=None) -> EGState:
    """Uniform weights and Theorem 2's eta, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    eta = default_eta(n_policies, horizon) if eta is None else float(eta)
    f32 = dict(dtype=torch.float32, device=dev)
    return EGState(
        weights=torch.full((n_policies,), 1.0 / n_policies, **f32),
        eta=torch.tensor(eta, **f32),
        k=torch.tensor(0, dtype=torch.int32, device=dev),
        cum_expected=torch.tensor(0.0, **f32),
        cum_utils=torch.zeros((n_policies,), **f32),
    )


def run_eg_scan(state: EGState, utilities: torch.Tensor,
                track_history: bool = False, collect: bool = False):
    """Run the EG update over every row of ``utilities`` ((K, M), clipped to
    [0, 1] here exactly like the numpy loop), on the state's device.
    Returns ``(final_state, traj)``; ``traj`` holds the per-job
    post-update trajectories:

      max_weight  (K,)   max_m w_k[m] — iters-to-half-weight reads off this
      regret      (K,)   max_m cum_utils - cum_expected after job k
      weights     (K, M) only when ``track_history``
      entropy     (K,)   only when ``collect`` — Shannon entropy of w_k,
                         the flight recorder's convergence gauge
      top_policy  (K,)   only when ``collect`` — argmax_m w_k[m], i32
                         (first-max ties, matching the numpy loop)

    Both flags only add outputs: with them off the loop runs the ops it ran
    without them. The numpy loop floors weights at 1e-300 before the log;
    in f32 the floor is the smallest normal. Chaining calls on consecutive
    row blocks equals one call on their concatenation (the engine's
    chunked mode)."""
    u_all = torch.clamp(utilities.to(torch.float32), 0.0, 1.0)
    tiny = torch.finfo(torch.float32).tiny
    w, eta, k, ce, cu = state
    max_w, regrets, hist, ent, top = [], [], [], [], []
    for u in u_all:
        ce = ce + torch.dot(w, u)
        cu = cu + u
        logits = torch.log(torch.clamp_min(w, tiny)) + eta * u
        logits = logits - logits.max()
        w = torch.exp(logits)
        w = w / w.sum()
        max_w.append(w.max())
        regrets.append(cu.max() - ce)
        if track_history:
            hist.append(w)
        if collect:
            ent.append(-torch.sum(w * torch.log(torch.clamp_min(w, tiny))))
            top.append(torch.argmax(w))
    n = u_all.shape[0]
    empty = u_all.new_zeros((0,))
    traj = {
        "max_weight": torch.stack(max_w) if n else empty,
        "regret": torch.stack(regrets) if n else empty,
    }
    if track_history:
        traj["weights"] = (torch.stack(hist) if n
                           else u_all.new_zeros((0, w.shape[0])))
    if collect:
        traj["entropy"] = torch.stack(ent) if n else empty
        traj["top_policy"] = (torch.stack(top).to(torch.int32) if n
                              else empty.to(torch.int32))
    return EGState(w, eta, k + n, ce, cu), traj


def iters_to_half(max_weight) -> int:
    """First 1-based update index where the leader's weight exceeds 0.5
    (K if it never does) — Fig. 9's convergence metric."""
    hit = _np(max_weight) > 0.5
    return int(np.argmax(hit)) + 1 if hit.any() else len(hit)
