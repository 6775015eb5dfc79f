"""The optimizer (AdamW over the LoRA leaf list) and learning-rate
schedules."""
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["adamw", "constant", "warmup_cosine"]
