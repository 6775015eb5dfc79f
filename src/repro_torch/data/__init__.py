"""Synthetic data: the scenario grid's market regimes."""
from repro_torch.data.synthetic import (market_regime_batch,
                                        market_regime_fault_batch)

__all__ = ["market_regime_batch", "market_regime_fault_batch"]
