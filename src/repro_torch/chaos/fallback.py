"""Online prediction-failure fallback: the ``fallback=`` flag.

The paper's complementary prediction-free algorithm (AHANP, Alg. 3) as a
*runtime degradation path* for the prediction-consuming AHAP lanes: the
pool simulator's slot loop carries a per-job realized-forecast-error EWMA
(last slot's 1-step-ahead forecast against this slot's observed price and
availability), and while the EWMA exceeds ``threshold`` every AHAP lane of
the job takes its decision from the AHANP rule instead of the window
solve. Plans keep updating underneath, so when the monitor recovers the
lane resumes AHAP with a warm plan history.

Port of the JAX package's ``chaos/fallback.py``. ``FallbackConfig`` stays a
frozen (hashable) dataclass; ``fallback=None`` (the default everywhere)
runs exactly the ops of the program without the monitor.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FallbackConfig:
    """Knobs of the prediction-health monitor (all static constants).

    ``threshold``     EWMA level above which a lane runs AHANP instead of
                      AHAP (relative-error units; 0.5 means the blended
                      1-step forecast has been ~50% off lately)
    ``lam``           EWMA smoothing weight of the newest error sample
    ``price_weight``  blend between the price relative error (weight
                      ``price_weight``) and the availability relative
                      error (``1 - price_weight``)
    """
    threshold: float = 0.5
    lam: float = 0.25
    price_weight: float = 0.5

    def __post_init__(self):
        if not (self.threshold > 0):
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
        if not (0 < self.lam <= 1):
            raise ValueError(f"lam must be in (0, 1], got {self.lam}")
        if not (0 <= self.price_weight <= 1):
            raise ValueError(
                f"price_weight must be in [0, 1], got {self.price_weight}")
