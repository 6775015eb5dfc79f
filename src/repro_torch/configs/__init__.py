"""Scheduling configs (the model configs are not ported yet)."""
from repro_torch.configs.base import JobConfig, ThroughputConfig

__all__ = ["JobConfig", "ThroughputConfig"]
