"""Policy pool construction (paper Sec. V-A / VI-A), a copy of the JAX
package's ``core/policy_pool.py``.

The paper's pool: 105 AHAP policies (omega in 1..5, v in 1..omega, sigma in
{0.3 .. 0.9}) + 7 AHANP policies (same sigmas) = 112. ``PolicySpec`` is the
encoding shared by the python reference policies (``PolicySpec.build``,
``build_selector``) and the vectorized simulator (:func:`specs_to_arrays`).

Beyond the paper: Robust-AHAP (``robust_pool``, rho < 1), RAND_DEADLINE
(``rand_deadline_pool``: the randomized commitment-threshold strategies of
arXiv:2601.14612, one lane per quantile of the commitment CDF) and region
lanes (``region_pool``: scheduling policies crossed with region-selection
strategies for ``fast_sim.simulate_pool_regions``, SkyNomad,
arXiv:2601.06520).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.policies import (
    AHANP,
    AHANPParams,
    AHAP,
    AHAPParams,
    BasePolicy,
    MSU,
    ODOnly,
    RSEL_AVAIL,
    RSEL_FIXED,
    RSEL_NAMES,
    RSEL_PRED,
    RSEL_PRICE,
    RandDeadline,
    RandDeadlineParams,
    RegionSelector,
    RegionSelectorParams,
    UP,
    rand_commit_frac,
    uniform_commit_frac,
)

KIND_AHAP, KIND_AHANP, KIND_OD, KIND_MSU, KIND_UP = 0, 1, 2, 3, 4
KIND_RAND = 5
KIND_NAMES = {0: "ahap", 1: "ahanp", 2: "od_only", 3: "msu", 4: "up",
              5: "rand_deadline"}

SIGMAS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
OMEGAS = (1, 2, 3, 4, 5)
RAND_QS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


@dataclass(frozen=True)
class PolicySpec:
    kind: int
    omega: int = 0
    v: int = 0
    sigma: float = 0.0
    rho: float = 1.0  # Robust-AHAP availability discount (1.0 = paper AHAP)
    # RAND_DEADLINE commitment-fraction override; < 0 derives the ski-rental
    # optimal fraction from sigma (the quantile) via rand_commit_frac.
    cfrac: float = -1.0
    # multi-region selection: strategy (RSEL_*) + hysteresis margin. The
    # defaults are a no-op for single-region simulation paths, which ignore
    # both fields.
    rsel: int = RSEL_FIXED
    rmargin: float = 0.0

    @property
    def name(self) -> str:
        if self.kind == KIND_AHAP:
            r = f",r={self.rho:.2f}" if self.rho < 1.0 else ""
            base = f"ahap(w={self.omega},v={self.v},s={self.sigma:.1f}{r})"
        elif self.kind == KIND_AHANP:
            base = f"ahanp(s={self.sigma:.1f})"
        elif self.kind == KIND_RAND:
            f = f",f={self.cfrac:.2f}" if self.cfrac >= 0 else ""
            base = f"rand_ddl(q={self.sigma:.2f}{f})"
        else:
            base = KIND_NAMES[self.kind]
        if self.rsel != RSEL_FIXED:
            m = f",m={self.rmargin:g}" if self.rmargin > 0 else ""
            base += f"@{RSEL_NAMES[self.rsel]}{m}"
        return base

    def build(self, device=None) -> BasePolicy:
        """The spec's python reference policy; an AHAP solves its windows
        on ``device`` (None: the card)."""
        if self.kind == KIND_AHAP:
            return AHAP(AHAPParams(self.omega, self.v, self.sigma, self.rho),
                        device=device)
        if self.kind == KIND_AHANP:
            return AHANP(AHANPParams(self.sigma))
        if self.kind == KIND_RAND:
            cf = self.cfrac if self.cfrac >= 0 else None
            return RandDeadline(RandDeadlineParams(self.sigma, cf))
        return {KIND_OD: ODOnly, KIND_MSU: MSU, KIND_UP: UP}[self.kind]()

    def build_selector(self) -> RegionSelector:
        return RegionSelector(RegionSelectorParams(self.rsel, self.rmargin))


def paper_pool(
    omegas: Sequence[int] = OMEGAS,
    sigmas: Sequence[float] = SIGMAS,
    fixed_v: Optional[int] = None,
    fixed_sigma: Optional[float] = None,
    include_ahanp: bool = True,
    rand_qs: Optional[Sequence[float]] = None,
) -> List[PolicySpec]:
    """105 AHAP + 7 AHANP by default; the fixed_* arguments reproduce the
    Fig. 9 hyperparameter-ablation pools (e.g. v=1 only, or sigma=0.9 only).
    ``rand_qs`` appends RAND_DEADLINE lanes (see rand_deadline_pool)."""
    pool: List[PolicySpec] = []
    for w in omegas:
        for v in range(1, w + 1):
            if fixed_v is not None and v != fixed_v:
                continue
            for s in sigmas:
                if fixed_sigma is not None and abs(s - fixed_sigma) > 1e-9:
                    continue
                pool.append(PolicySpec(KIND_AHAP, w, v, s))
    if include_ahanp:
        for s in sigmas:
            if fixed_sigma is not None and abs(s - fixed_sigma) > 1e-9:
                continue
            pool.append(PolicySpec(KIND_AHANP, 0, 0, s))
    if rand_qs is not None:
        pool.extend(rand_deadline_pool(rand_qs))
    return pool


def rand_deadline_pool(
    qs: Sequence[float] = RAND_QS,
    qfn: Optional[Callable[[float], float]] = None,
) -> List[PolicySpec]:
    """Randomized commitment-threshold strategies, one lane per quantile of
    the commitment CDF; the quantile rides the ``sigma`` slot. ``qfn`` is
    the quantile function (None keeps the ski-rental-optimal family,
    :func:`rand_commit_frac`); any other callable is evaluated here in
    float64 and carried on the spec's ``cfrac`` slot."""
    if qfn is None:
        return [PolicySpec(KIND_RAND, 0, 0, q) for q in qs]
    pool = []
    for q in qs:
        cf = float(qfn(q))
        if not 0.0 <= cf <= 1.0:  # a negative cf would silently collide
            raise ValueError(     # with the 'unset' cfrac sentinel (< 0)
                f"quantile function returned commitment fraction {cf} for "
                f"q={q}; must lie in [0, 1] (a fraction of the deadline)"
            )
        pool.append(PolicySpec(KIND_RAND, 0, 0, q, cfrac=cf))
    return pool


def uniform_rand_deadline_pool(
        qs: Sequence[float] = RAND_QS) -> List[PolicySpec]:
    """The uniform-commitment control family: commit at fraction q
    itself."""
    return rand_deadline_pool(qs, qfn=uniform_commit_frac)


def baseline_specs() -> List[PolicySpec]:
    return [PolicySpec(KIND_OD), PolicySpec(KIND_MSU), PolicySpec(KIND_UP)]


def robust_pool(
    rhos: Sequence[float] = (0.5, 0.7, 0.85),
    omegas: Sequence[int] = (3, 5),
    sigmas: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
) -> List[PolicySpec]:
    """Robust-AHAP candidates (availability-pessimistic)."""
    return [
        PolicySpec(KIND_AHAP, w, 1, s, rho=r)
        for r in rhos for w in omegas for s in sigmas
    ]


def region_pool(
    base: Optional[Sequence[PolicySpec]] = None,
    strategies: Sequence[int] = (RSEL_PRICE, RSEL_AVAIL, RSEL_PRED),
    margins: Sequence[float] = (0.0, 0.05),
) -> List[PolicySpec]:
    """Scheduling policies crossed with region-selection strategies, so the
    selector learns region strategy and scheduling policy jointly (Thm. 2's
    sqrt(log M) regret keeps the expansion cheap). ``base`` defaults to a
    compact slate (three AHAP corners, one AHANP, MSU, UP); each base spec
    is crossed with every (strategy, hysteresis margin) pair: margin 0 is
    plain greedy, margin > 0 the sticky variant. 36 lanes by default."""
    if base is None:
        base = [
            PolicySpec(KIND_AHAP, 3, 1, 0.5),
            PolicySpec(KIND_AHAP, 3, 1, 0.9),
            PolicySpec(KIND_AHAP, 5, 2, 0.7),
            PolicySpec(KIND_AHANP, 0, 0, 0.7),
            PolicySpec(KIND_MSU),
            PolicySpec(KIND_UP),
        ]
    return [
        replace(spec, rsel=s, rmargin=m)
        for spec in base for s in strategies for m in margins
    ]


def specs_to_arrays(pool: Sequence[PolicySpec]) -> dict:
    """Array encoding for the simulator (numpy; the simulator moves it to
    its device). ``cfrac`` is the RAND_DEADLINE commitment fraction,
    precomputed in float64 so every simulator floors identical f32 bits.
    ``rsel``/``rmargin`` encode the region-selection strategy; the
    single-region entry points ignore them."""
    return {
        "kind": np.array([p.kind for p in pool], np.int32),
        "omega": np.array([p.omega for p in pool], np.int32),
        "v": np.array([max(p.v, 1) for p in pool], np.int32),
        "sigma": np.array([p.sigma for p in pool], np.float32),
        "rho": np.array([p.rho for p in pool], np.float32),
        "cfrac": np.array(
            [(p.cfrac if p.cfrac >= 0 else rand_commit_frac(p.sigma))
             if p.kind == KIND_RAND else 0.0
             for p in pool], np.float32,
        ),
        "rsel": np.array([p.rsel for p in pool], np.int32),
        "rmargin": np.array([p.rmargin for p in pool], np.float32),
    }
