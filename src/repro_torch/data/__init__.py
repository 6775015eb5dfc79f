"""Synthetic data: the scenario grid's market regimes and the token streams
LoRA fine-tuning trains on, and the deterministic loader."""
from repro_torch.data.loader import ShardedLMLoader
from repro_torch.data.synthetic import (MarkovLM, lm_batches,
                                        market_regime_batch,
                                        market_regime_fault_batch,
                                        token_stream)

__all__ = ["MarkovLM", "ShardedLMLoader", "lm_batches",
           "market_regime_batch", "market_regime_fault_batch",
           "token_stream"]
